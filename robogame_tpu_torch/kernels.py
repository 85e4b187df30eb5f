"""Build, bind and launch the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled at first use by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface under
``build/robogame_tpu_torch/`` beside the package (named by a hash of the
source and the flags), and bound with ``ctypes``:

* K1, ``csrc/exact_step.cu``: the event-order-exact control step;
* K2, ``csrc/qp_grouped.cu``: the batched ADMM QP solve of problems that
  share H and A (a factor setup per group, then the factor-free
  iterations over tiles of problems), and ``csrc/qp_admm.cu``: the same
  solve one problem a warp, for every other problem;
* K3, ``csrc/dmpc_sqp.cu``: the fused single-agent DMPC SQP solve;
* K4, ``csrc/cmpc_sqp.cu``: the fused joint two-player CMPC SQP solve;
* K5, ``csrc/qp_joint.cu``: the structured two-agent QP solve;
* K6, ``csrc/parallel_step.cu``: the parallel-resolution control step;
* the draw kernel, ``csrc/game_noise.cu``: every game's standard normals
  of a stochastic step from its own Philox stream (no TPU kernel: the
  counterpart of JAX's XLA threefry draws, ``physics/noise.py``).

K3 and K4 share their knot-structured SQP machinery (the constraint
operator applied through the position sensitivities, never as a stored A)
in ``csrc/knot_sqp.cuh``, whose one-sweep Cholesky factor and inverse K5
takes too; K5 keeps its block-Schur ADMM on a general A in
``csrc/joint_schur.cuh``; K1 and K6, each a warp a game, share their
constants, RK4, the warp's detect and the plane copies in
``csrc/step_common.cuh``.  A library's name hashes its source with the
headers it includes (``HEADERS``) and its flags.

:func:`build_all` starts one ``nvcc`` per source that is not built yet, all
at once.  Nothing here runs while the module is imported, so the CPU tests
import it freely.

Flags (``flags``): every library builds with ``-O3`` for ``sm_90a``, no
fast math, IEEE division and correctly rounded square root.  ``FMAD`` says
which may contract a product and a sum into one FMA: K2's grouped route
(``qp_grouped``), K3 (``dmpc_sqp``) and K4 (``cmpc_sqp``) do
(``-fmad=true``, and ``-Xptxas=-v``, whose report lands in
``build_log``), as they are held to their plain versions by tolerance and
to lie no further from the f64 solution than the plain f32 version
(``profile_qp.py``, ``profile_sqp.py``); K1, K2's per-problem kernel, K5,
K6 and the draw kernel build with ``-fmad=false``, so each float
operation is the one their plain versions do (K1 and K6 are held to
theirs bitwise; K5 with FMA contraction lay further from the f64
solution, ``profile_sqp.py``).

``occupancy(name, N, n_obs)`` asks K3's or K4's library for the problems
an SM it runs (one a block; the card's occupancy calculator) and its
shared bytes a problem, ``qp_joint_occupancy(n1, m_own, m_pair)`` the same
of K5; ``qp_grouped_occupancy()`` asks the same of K2's grouped
iterations (80 problems a block); ``step_occupancy(name, K1, stochastic)``
asks K1's (``exact_step``) or K6's (``parallel_step``) library for the
blocks of WPB = 4 games an SM runs at K1 grid columns.

Launch counters, added to only by the launch paths below: ``launches``
holds K1's per mode, ``qp_launches`` K2's per-problem launches per (n, m)
shape, ``qp_grouped_launches`` its grouped launches (the setup and the
iterations, one count) and ``qp_listed_launches`` the per-problem launches
over a grouped launch's equality-row problems, ``sqp_launches`` K3's per
(n1, m_own) shape, ``cmpc_launches`` K4's and ``joint_launches`` K5's per
(n1, m_own, m_pair) shape, ``parallel_launches`` K6's per mode,
``noise_launches`` the draw kernel's per substream, ``word_launches``
its raw-word kernel's (used only to hold the words to the plain
version's).
:func:`k2_routes` reads how many problems each K2 route solved since
:func:`reset_launches` (the grouped ones and the listed ones are counted
on the device).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent
SOURCES = {"exact_step": _PKG / "csrc" / "exact_step.cu",
           "qp_admm": _PKG / "csrc" / "qp_admm.cu",
           "qp_grouped": _PKG / "csrc" / "qp_grouped.cu",
           "dmpc_sqp": _PKG / "csrc" / "dmpc_sqp.cu",
           "cmpc_sqp": _PKG / "csrc" / "cmpc_sqp.cu",
           "qp_joint": _PKG / "csrc" / "qp_joint.cu",
           "parallel_step": _PKG / "csrc" / "parallel_step.cu",
           "game_noise": _PKG / "csrc" / "game_noise.cu"}
# the headers each source includes (hashed with it)
HEADERS = {"exact_step": [_PKG / "csrc" / "step_common.cuh"],
           "dmpc_sqp": [_PKG / "csrc" / "knot_sqp.cuh"],
           "cmpc_sqp": [_PKG / "csrc" / "knot_sqp.cuh"],
           "qp_joint": [_PKG / "csrc" / "joint_schur.cuh",
                        _PKG / "csrc" / "knot_sqp.cuh"],
           "parallel_step": [_PKG / "csrc" / "step_common.cuh"]}
BUILD_DIR = _PKG.parent / "build" / "robogame_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# the libraries built with FMA contraction (the others with -fmad=false);
# their builds also report ptxas's registers, spills and shared memory
# (``build_log``)
FMAD = {"dmpc_sqp", "cmpc_sqp", "qp_grouped"}


def flags(name: str) -> list:
    """The nvcc flags of one library."""
    if name in FMAD:
        return [*NVCC_FLAGS, "-fmad=true", "-Xptxas=-v"]
    return [*NVCC_FLAGS, "-fmad=false"]

_MODE_ID = {"exact": 0, "exact_export": 1, "exact_resume": 2}
launches = {mode: 0 for mode in _MODE_ID}
_PARALLEL_MODE_ID = {"full": 0, "export": 1, "resume": 2}
parallel_launches = {mode: 0 for mode in _PARALLEL_MODE_ID}
noise_launches = {s: 0 for s in range(4)}
word_launches = {"words": 0}
qp_launches: dict = {}
qp_grouped_launches: dict = {}
qp_listed_launches: dict = {}
sqp_launches: dict = {}
cmpc_launches: dict = {}
joint_launches: dict = {}
build_seconds: dict = {}
build_log: dict = {}         # nvcc's messages of each library built here
_routed: dict = {}           # device -> int64 (2,): grouped, listed problems
_qp_direct: dict = {}        # K2's per-problem launches' problems, per shape
_libs: dict = {}


def reset_launches() -> None:
    for counts in (launches, parallel_launches, noise_launches,
                   word_launches):
        for mode in counts:
            counts[mode] = 0
    for counts in (qp_launches, qp_grouped_launches, qp_listed_launches,
                   _qp_direct, sqp_launches, cmpc_launches, joint_launches):
        counts.clear()
    for c in _routed.values():
        c.zero_()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(cand)


def _out_path(name: str) -> Path:
    text = b"".join(f.read_bytes() for f in [SOURCES[name],
                                             *HEADERS.get(name, [])])
    digest = hashlib.sha256(text + " ".join(flags(name)).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=None) -> dict:
    """Compile the named kernels (default: all) that have no library built
    from their current source and flags, one ``nvcc`` each, all started
    together; returns {name: library path}."""
    names = list(SOURCES) if names is None else list(names)
    outs = {name: _out_path(name) for name in names}
    todo = [name for name in names if not outs[name].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        jobs = {}
        for name in todo:
            tmp = outs[name].with_suffix(f".{os.getpid()}.tmp")
            jobs[name] = (tmp, subprocess.Popen(
                [nvcc, *flags(name), "-o", str(tmp), str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        failed = []
        for name, (tmp, proc) in jobs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{err}")
                continue
            os.replace(tmp, outs[name])
            build_seconds[name] = time.perf_counter() - t0
            build_log[name] = err
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return outs


def build(name: str) -> Path:
    """Compile one kernel unless it is built; returns its library."""
    return build_all([name])[name]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# each library's C entry point and its arguments (pointers and the stream
# as void*, so that ctypes passes them as 64-bit values)
_SIGNATURES = {
    "exact_step": ("rg_exact_step", [_P] * 13 + [_I] * 4 + [_P]),
    "qp_admm": ("rg_qp_admm", [_P] * 7 + [_I] * 6 + [_F] * 5 + [_P]),
    "qp_grouped": ("rg_qp_grouped", [_P] * 12 + [_I] * 6 + [_F] * 5 + [_P]),
    "dmpc_sqp": ("rg_dmpc_sqp", [_P] * 12 + [_I] * 7 + [_F] * 7 + [_P]),
    "cmpc_sqp": ("rg_cmpc_sqp", [_P] * 12 + [_I] * 7 + [_F] * 7 + [_P]),
    "qp_joint": ("rg_qp_joint", [_P] * 9 + [_I] * 6 + [_F] * 6 + [_P]),
    "parallel_step": ("rg_parallel_step", [_P] * 14 + [_I] * 4 + [_P]),
    "game_noise": ("rg_game_normals", [_P] * 2 + [_I] * 5 + [_P]),
}


# the occupancy queries of K3 and K4: (N, M, int out[2])
_OCCUPANCY = {"dmpc_sqp": "rg_dmpc_sqp_occupancy",
              "cmpc_sqp": "rg_cmpc_sqp_occupancy"}


# further entry points of a library: (name, argument types)
_EXTRA = {
    "qp_admm": [("rg_qp_admm_listed", [_P] * 10 + [_I] * 6 + [_F] * 5
                 + [_P])],
    "qp_grouped": [("rg_qp_grouped_setup", [_P] * 4 + [_I] * 3 + [_F, _P]),
                   ("rg_qp_grouped_occupancy", [_P])],
    "qp_joint": [("rg_qp_joint_occupancy", [_I] * 3 + [_P])],
    "game_noise": [("rg_game_words", [_P] * 2 + [_I] * 4 + [_P])],
    "exact_step": [("rg_exact_step_occupancy", [_I] * 2 + [_P])],
    "parallel_step": [("rg_parallel_step_occupancy", [_I] * 2 + [_P])],
}


def _library(name: str):
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        fn_name, argtypes = _SIGNATURES[name]
        extra = list(_EXTRA.get(name, []))
        if name in _OCCUPANCY:
            extra.append((_OCCUPANCY[name], [_I, _I, _P]))
        for fn_name, argtypes in [(fn_name, argtypes), *extra]:
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def occupancy(name: str, N: int, n_obs: int) -> dict:
    """The problems an SM that K3 (``dmpc_sqp``) or K4 (``cmpc_sqp``) runs
    at N knots and n_obs keepouts a knot on the current card (one problem a
    block), and its shared bytes a problem."""
    out = (ctypes.c_int * 2)()
    err = getattr(_library(name), _OCCUPANCY[name])(int(N), int(n_obs),
                                                     ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{name} occupancy query failed: cudaError {err}")
    return {"problems_per_sm": out[0], "smem_bytes": out[1]}


# games (warps) a block of K1 and K6 (csrc/step_common.cuh)
STEP_WPB = 4


def step_occupancy(name: str, K1: int, stochastic: bool = False) -> dict:
    """The blocks an SM that K1 (``exact_step``) or K6 (``parallel_step``)
    runs at K1 grid columns on the current card (the occupancy calculator
    at the launch's dynamic shared memory; stochastic K1 stages its
    re-propagation noise there too), the games that makes an SM, the
    shared bytes a block and the registers a thread."""
    if name not in ("exact_step", "parallel_step"):
        raise ValueError(f"step_occupancy: exact_step or parallel_step, not "
                         f"{name!r}")
    out = (ctypes.c_int * 3)()
    err = getattr(_library(name), f"rg_{name}_occupancy")(
        int(K1), int(bool(stochastic)), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{name} occupancy query failed: cudaError {err}")
    return {"blocks_per_sm": out[0], "games_per_sm": out[0] * STEP_WPB,
            "smem_bytes": out[1], "registers": out[2]}


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(name, t, shape, dev):
    if t.device != dev or t.dtype != torch.float32 or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous float32 {tuple(shape)} on {dev}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def exact_step(M6, consts: np.ndarray, x, u, meta, dmg, noise, rnoise,
               grid_in, carry_in, mode: str, cap: int):
    """Launch K1 over B games on the current stream.  Returns (xout (20,B),
    aux (24,B), grid (20,G+1,B), carry (48,B) or None); ``grid_in`` is
    copied, not modified."""
    dev = x.device
    B = x.shape[1]
    K1 = M6.shape[1]
    for name, t, shape in (("M6", M6, (20, K1, 6)), ("x", x, (20, B)),
                           ("u", u, (10, B)), ("meta", meta, (8, B)),
                           ("dmg", dmg, (16, B))):
        _check(name, t, shape, dev)
    for name, t in (("noise", noise), ("rnoise", rnoise)):
        if t is not None:
            _check(name, t, (20, K1, B), dev)
    if mode == "exact_resume":
        _check("grid_in", grid_in, (20, K1, B), dev)
        _check("carry_in", carry_in, (48, B), dev)
        grid = grid_in.clone()
    else:
        grid = torch.empty((20, K1, B), dtype=torch.float32, device=dev)
    xout = torch.empty((20, B), dtype=torch.float32, device=dev)
    aux = torch.empty((24, B), dtype=torch.float32, device=dev)
    carry = (torch.empty((48, B), dtype=torch.float32, device=dev)
             if mode == "exact_export" else None)
    if B == 0:
        return xout, aux, grid, carry
    consts = np.ascontiguousarray(consts, dtype=np.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library("exact_step").rg_exact_step(
            consts.ctypes.data, _ptr(M6), _ptr(x), _ptr(u), _ptr(meta),
            _ptr(dmg), _ptr(noise), _ptr(rnoise), _ptr(grid),
            _ptr(carry_in if mode == "exact_resume" else None), _ptr(xout),
            _ptr(aux), _ptr(carry), B, K1, _MODE_ID[mode], int(cap),
            stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    launches[mode] += 1
    return xout, aux, grid, carry


def parallel_step(M6, FI, SP, consts: np.ndarray, x, u, meta, dmg, noise,
                  grid_in, carry_in, mode: str, cap: int):
    """Launch K6 over B games on the current stream, a warp a game.
    Returns (xout (20,B), aux (24,B), grid (20,G+1,B), carry (32,B)
    or None); ``grid_in`` is copied, not modified."""
    dev = x.device
    B = x.shape[1]
    K1 = M6.shape[1]
    if mode not in _PARALLEL_MODE_ID:
        raise ValueError(f"K6 mode must be one of {tuple(_PARALLEL_MODE_ID)}"
                         f", got {mode!r}")
    for name, t, shape in (("M6", M6, (20, K1, 6)), ("FI", FI, (80, K1)),
                           ("SP", SP, (40, K1)), ("x", x, (20, B)),
                           ("u", u, (10, B)), ("meta", meta, (8, B)),
                           ("dmg", dmg, (16, B))):
        _check(name, t, shape, dev)
    if noise is not None:
        _check("noise", noise, (20, K1, B), dev)
    if mode == "resume":
        _check("grid_in", grid_in, (20, K1, B), dev)
        _check("carry_in", carry_in, (32, B), dev)
        grid = grid_in.clone()
    else:
        grid = torch.empty((20, K1, B), dtype=torch.float32, device=dev)
    xout = torch.empty((20, B), dtype=torch.float32, device=dev)
    aux = torch.empty((24, B), dtype=torch.float32, device=dev)
    carry = (torch.empty((32, B), dtype=torch.float32, device=dev)
             if mode == "export" else None)
    if B == 0:
        return xout, aux, grid, carry
    consts = np.ascontiguousarray(consts, dtype=np.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library("parallel_step").rg_parallel_step(
            consts.ctypes.data, _ptr(M6), _ptr(FI), _ptr(SP), _ptr(x),
            _ptr(u), _ptr(meta), _ptr(dmg),
            _ptr(noise if mode != "resume" else None), _ptr(grid),
            _ptr(carry_in if mode == "resume" else None), _ptr(xout),
            _ptr(aux), _ptr(carry), B, K1, _PARALLEL_MODE_ID[mode],
            int(cap), stream)
    if err != 0:
        raise RuntimeError(f"K6 launch failed: cudaError {err}")
    parallel_launches[mode] += 1
    return xout, aux, grid, carry


def _routed_counter(dev):
    c = _routed.get(dev)
    if c is None:
        c = _routed[dev] = torch.zeros(2, dtype=torch.int64, device=dev)
    return c


def k2_routes() -> dict:
    """The problems K2 solved since :func:`reset_launches`, by route:
    ``grouped`` (``csrc/qp_grouped.cu``), ``listed`` (a grouped launch's
    equality-row problems on the per-problem kernel) and ``per_problem``
    (the per-problem kernel's own launches).  One host fetch."""
    got = [0, 0]
    for c in _routed.values():
        got = [a + int(b) for a, b in zip(got, c.tolist())]
    return {"grouped": got[0], "listed": got[1],
            "per_problem": sum(_qp_direct.values())}


def qp_grouped(H, g, A, l, u, group: int, n_seg: int, seg_iters: int,
               rho: float, sigma: float, alpha: float, tol: float):
    """K2's grouped route over P = g.shape[0] problems on the current
    stream: H (G, n, n) and A (G, m, n) shared by groups of ``group``,
    g (P, n), l/u (P, m).  Launches the setup and the iterations
    (``csrc/qp_grouped.cu``), then the per-problem kernel over the problems
    with an equality row, whose list and count stay on the device.
    Returns x (P, n) and stats (P, 3) = [converged, prim_res, dual_res]."""
    dev = g.device
    P, n = g.shape
    m = A.shape[1]
    G = P // group
    for name, t, shape in (("H", H, (G, n, n)), ("g", g, (P, n)),
                           ("A", A, (G, m, n)), ("l", l, (P, m)),
                           ("u", u, (P, m))):
        _check(name, t, shape, dev)
    x = torch.empty((P, n), dtype=torch.float32, device=dev)
    stats = torch.empty((P, 3), dtype=torch.float32, device=dev)
    if P == 0:
        return x, stats
    W = torch.empty((G, 32, 32), dtype=torch.float32, device=dev)
    lam = torch.empty((G, 32), dtype=torch.float32, device=dev)
    listed = torch.empty(P, dtype=torch.int32, device=dev)
    n_listed = torch.empty(1, dtype=torch.int32, device=dev)
    routed = _routed_counter(dev)
    args = (int(group), int(n_seg), int(seg_iters), float(rho),
            float(sigma), float(alpha), float(tol), float(10.0 * tol))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library("qp_grouped").rg_qp_grouped(
            _ptr(H), _ptr(g), _ptr(A), _ptr(l), _ptr(u), _ptr(W), _ptr(lam),
            _ptr(x), _ptr(stats), _ptr(listed), _ptr(n_listed),
            _ptr(routed), P, n, m, *args, stream)
        if err != 0:
            raise RuntimeError(f"K2 grouped launch failed: cudaError {err} "
                               f"(P={P}, n={n}, m={m}, group={group})")
        qp_grouped_launches[(n, m)] = qp_grouped_launches.get((n, m), 0) + 1
        err = _library("qp_admm").rg_qp_admm_listed(
            _ptr(H), _ptr(g), _ptr(A), _ptr(l), _ptr(u), _ptr(x),
            _ptr(stats), _ptr(listed), _ptr(n_listed), _ptr(routed), P, n, m,
            *args, stream)
    if err != 0:
        raise RuntimeError(f"K2 listed launch failed: cudaError {err} "
                           f"(P={P}, n={n}, m={m}, group={group})")
    qp_listed_launches[(n, m)] = qp_listed_launches.get((n, m), 0) + 1
    return x, stats


def qp_grouped_setup(H, A, sigma: float):
    """The grouped route's setup kernel alone on G operands H (G, n, n),
    A (G, m, n): returns W (G, 32, 32) and lam (G, 32) (zero beyond n).
    Counts no launch."""
    dev = H.device
    G, n = H.shape[0], H.shape[-1]
    m = A.shape[1]
    _check("H", H, (G, n, n), dev)
    _check("A", A, (G, m, n), dev)
    W = torch.empty((G, 32, 32), dtype=torch.float32, device=dev)
    lam = torch.empty((G, 32), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library("qp_grouped").rg_qp_grouped_setup(
            _ptr(H), _ptr(A), _ptr(W), _ptr(lam), G, n, m, float(sigma),
            stream)
    if err != 0:
        raise RuntimeError(f"K2 setup launch failed: cudaError {err}")
    return W, lam


def qp_grouped_occupancy() -> dict:
    """The blocks (80 problems each) of K2's grouped iterations an SM runs
    on the current card, and their shared bytes."""
    out = (ctypes.c_int * 2)()
    err = _library("qp_grouped").rg_qp_grouped_occupancy(
        ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"qp_grouped occupancy query failed: cudaError "
                           f"{err}")
    return {"blocks_per_sm": out[0], "smem_bytes": out[1]}


def qp_joint_occupancy(n1: int, m_own: int, m_pair: int) -> dict:
    """The problems an SM that K5 runs at (n1, m_own, m_pair) on the
    current card (one a block), and its shared bytes a problem."""
    out = (ctypes.c_int * 2)()
    err = _library("qp_joint").rg_qp_joint_occupancy(
        int(n1), int(m_own), int(m_pair), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"qp_joint occupancy query failed: cudaError "
                           f"{err}")
    return {"problems_per_sm": out[0], "smem_bytes": out[1]}


def qp_admm(H, g, A, l, u, group: int, n_seg: int, seg_iters: int,
            rho: float, sigma: float, alpha: float, tol: float):
    """Launch K2 over P = g.shape[0] problems on the current stream: H
    (P/group, n, n), g (P, n), A (P/group, m, n), l/u (P, m).  Returns
    x (P, n) and stats (P, 3) = [converged, prim_res, dual_res]."""
    dev = g.device
    P, n = g.shape
    m = A.shape[1]
    G = P // group
    for name, t, shape in (("H", H, (G, n, n)), ("g", g, (P, n)),
                           ("A", A, (G, m, n)), ("l", l, (P, m)),
                           ("u", u, (P, m))):
        _check(name, t, shape, dev)
    x = torch.empty((P, n), dtype=torch.float32, device=dev)
    stats = torch.empty((P, 3), dtype=torch.float32, device=dev)
    if P == 0:
        return x, stats
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library("qp_admm").rg_qp_admm(
            _ptr(H), _ptr(g), _ptr(A), _ptr(l), _ptr(u), _ptr(x),
            _ptr(stats), P, n, m, int(group), int(n_seg), int(seg_iters),
            float(rho), float(sigma), float(alpha), float(tol),
            float(10.0 * tol), stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {err} "
                           f"(P={P}, n={n}, m={m}, group={group})")
    qp_launches[(n, m)] = qp_launches.get((n, m), 0) + 1
    _qp_direct[(n, m)] = _qp_direct.get((n, m), 0) + P
    return x, stats


def dmpc_sqp(H, g, sg, p0, obs, lo_arena, hi_arena, lx, ux, U0, *, N: int,
             n_obs: int, n_seg0: int, it0: int, sqp_rest: int, it_rest: int,
             rho: float, sigma: float, alpha: float, tol: float, d2: float):
    """Launch K3 over B = g.shape[0] DMPC SQPs on the current stream (the
    layouts of ``ops/sqp_lanes.py``).  Returns x (B, n1) and stats (B, 5) =
    [converged, prim_res, dual_res, p_sc, d_sc]."""
    dev = g.device
    B, n1 = g.shape
    m_own = 2 * N + n_obs * N
    for name, t, shape in (("H", H, (B, n1, n1)), ("g", g, (B, n1)),
                           ("sg", sg, (B, N, 2, n1)), ("p0", p0, (B, N, 2)),
                           ("obs", obs, (B, n_obs, 2)),
                           ("lo_arena", lo_arena, (B, 2 * N)),
                           ("hi_arena", hi_arena, (B, 2 * N)),
                           ("lx", lx, (B, n1)), ("ux", ux, (B, n1)),
                           ("U0", U0, (B, n1))):
        _check(name, t, shape, dev)
    x = torch.empty((B, n1), dtype=torch.float32, device=dev)
    stats = torch.empty((B, 5), dtype=torch.float32, device=dev)
    if B == 0:
        return x, stats
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library("dmpc_sqp").rg_dmpc_sqp(
            _ptr(H), _ptr(g), _ptr(sg), _ptr(p0), _ptr(obs), _ptr(lo_arena),
            _ptr(hi_arena), _ptr(lx), _ptr(ux), _ptr(U0), _ptr(x),
            _ptr(stats), B, N, n_obs, int(n_seg0), int(it0), int(sqp_rest),
            int(it_rest), float(rho), float(sigma), float(alpha), float(tol),
            float(10.0 * tol), float(d2), float(1.0 / n1), stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {err} "
                           f"(B={B}, N={N}, n_obs={n_obs})")
    sqp_launches[(n1, m_own)] = sqp_launches.get((n1, m_own), 0) + 1
    return x, stats


def cmpc_sqp(Hb, g, sg, p0, obs, lo_arena, hi_arena, lx, ux, U0, *, N: int,
             n_obs: int, n_seg0: int, it0: int, sqp_rest: int, it_rest: int,
             rho: float, sigma: float, alpha: float, tol: float, d2: float):
    """Launch K4 over B = g.shape[0] joint CMPC SQPs on the current stream
    (the layouts of ``ops/sqp_lanes.py::solve_cmpc_sqp_lanes``).  Returns x
    (B, 2 n1) and stats (B, 5) = [converged, prim_res, dual_res, p_sc,
    d_sc]."""
    dev = g.device
    B = g.shape[0]
    n1 = 2 * N
    m_own = (2 + n_obs) * N
    for name, t, shape in (("Hb", Hb, (B, 2, n1, n1)), ("g", g, (B, 2 * n1)),
                           ("sg", sg, (B, 2, N, 2, n1)),
                           ("p0", p0, (B, 2, N, 2)),
                           ("obs", obs, (B, n_obs, 2)),
                           ("lo_arena", lo_arena, (B, 2, 2 * N)),
                           ("hi_arena", hi_arena, (B, 2, 2 * N)),
                           ("lx", lx, (B, 2 * n1)), ("ux", ux, (B, 2 * n1)),
                           ("U0", U0, (B, 2 * n1))):
        _check(name, t, shape, dev)
    x = torch.empty((B, 2 * n1), dtype=torch.float32, device=dev)
    stats = torch.empty((B, 5), dtype=torch.float32, device=dev)
    if B == 0:
        return x, stats
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library("cmpc_sqp").rg_cmpc_sqp(
            _ptr(Hb), _ptr(g), _ptr(sg), _ptr(p0), _ptr(obs), _ptr(lo_arena),
            _ptr(hi_arena), _ptr(lx), _ptr(ux), _ptr(U0), _ptr(x),
            _ptr(stats), B, N, n_obs, int(n_seg0), int(it0), int(sqp_rest),
            int(it_rest), float(rho), float(sigma), float(alpha), float(tol),
            float(10.0 * tol), float(d2), float(1.0 / (2 * n1)), stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {err} "
                           f"(B={B}, N={N}, n_obs={n_obs})")
    key = (n1, m_own, N)
    cmpc_launches[key] = cmpc_launches.get(key, 0) + 1
    return x, stats


def qp_joint(Hb, g, Ab, l, u, lx, ux, *, m_own: int, m_pair: int,
             n_seg: int, seg_iters: int, rho: float, sigma: float,
             alpha: float, tol: float):
    """Launch K5 over B = g.shape[0] structured joint QPs on the current
    stream (the layouts of ``ops/qp_lanes.py::solve_qp_lanes_joint``, rows
    already scaled).  Returns x (B, 2 n1) and stats (B, 5) = [converged,
    prim_res, dual_res, p_sc, d_sc]."""
    dev = g.device
    B = g.shape[0]
    n1 = Hb.shape[-1]
    R = 2 * m_own + m_pair
    for name, t, shape in (("Hb", Hb, (B, 2, n1, n1)), ("g", g, (B, 2 * n1)),
                           ("Ab", Ab, (B, 2, m_own + m_pair, n1)),
                           ("l", l, (B, R)), ("u", u, (B, R)),
                           ("lx", lx, (B, 2 * n1)), ("ux", ux, (B, 2 * n1))):
        _check(name, t, shape, dev)
    x = torch.empty((B, 2 * n1), dtype=torch.float32, device=dev)
    stats = torch.empty((B, 5), dtype=torch.float32, device=dev)
    if B == 0:
        return x, stats
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library("qp_joint").rg_qp_joint(
            _ptr(Hb), _ptr(g), _ptr(Ab), _ptr(l), _ptr(u), _ptr(lx),
            _ptr(ux), _ptr(x), _ptr(stats), B, n1, m_own, m_pair,
            int(n_seg), int(seg_iters), float(rho), float(sigma),
            float(alpha), float(tol), float(10.0 * tol),
            float(1.0 / (2 * n1)), stream)
    if err != 0:
        raise RuntimeError(f"K5 launch failed: cudaError {err} "
                           f"(B={B}, n1={n1}, m_own={m_own}, m_pair={m_pair})")
    key = (n1, m_own, m_pair)
    joint_launches[key] = joint_launches.get(key, 0) + 1
    return x, stats


def _check_keys(keys, substream, it):
    if keys.dtype != torch.int64 or keys.ndim != 2 or keys.shape[1] != 2 \
            or not keys.is_contiguous() or keys.device.type != "cuda":
        raise ValueError(f"draw kernel: expected contiguous int64 (B, 2) "
                         f"keys on the card, got {keys.dtype} "
                         f"{tuple(keys.shape)} on {keys.device}")
    if substream not in noise_launches or not 0 <= it < 2 ** 31:
        raise ValueError(f"draw kernel: substream {substream}, it {it}")


def game_words(keys, n_blocks: int, substream: int, it: int):
    """The raw Philox words (B, n_blocks, 4) int64 (each a uint32) of the
    blocks that :func:`game_normals` turns into normals, from the same
    file's second kernel."""
    _check_keys(keys, substream, it)
    B = keys.shape[0]
    out = torch.empty((B, n_blocks, 4), dtype=torch.int32,
                      device=keys.device)
    if B and n_blocks:
        with torch.cuda.device(keys.device):
            stream = torch.cuda.current_stream(keys.device).cuda_stream
            err = _library("game_noise").rg_game_words(
                _ptr(keys), _ptr(out), B, int(n_blocks), int(substream),
                int(it), stream)
        if err != 0:
            raise RuntimeError(f"word kernel launch failed: cudaError {err}")
        word_launches["words"] += 1
    return out.to(torch.int64) & 0xFFFFFFFF


def game_normals(keys, n: int, substream: int, it: int, dtype):
    """Launch the draw kernel on the current stream: (B, n) standard
    normals (f32 or f64) of each game's Philox ``substream`` at iteration
    ``it``, keys (B, 2) int64 [seed, counter] on the card
    (``physics/noise.py`` defines the stream)."""
    dev = keys.device
    _check_keys(keys, substream, it)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"draw kernel: float32 or float64, not {dtype}")
    B = keys.shape[0]
    out = torch.empty((B, n), dtype=dtype, device=dev)
    if B == 0 or n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library("game_noise").rg_game_normals(
            _ptr(keys), _ptr(out), B, int(n), int(substream), int(it),
            int(dtype == torch.float64), stream)
    if err != 0:
        raise RuntimeError(f"draw kernel launch failed: cudaError {err} "
                           f"(B={B}, n={n}, substream={substream})")
    noise_launches[substream] += 1
    return out
