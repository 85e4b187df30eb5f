"""Build, bind and launch the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled at first use by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface under
``build/robogame_tpu_torch/`` beside the package (named by a hash of the
source and the flags), and bound with ``ctypes``:

* K1, ``csrc/exact_step.cu``: the event-order-exact control step;
* K2, ``csrc/qp_admm.cu``: the batched dense ADMM QP solve;
* K3, ``csrc/dmpc_sqp.cu``: the fused single-agent DMPC SQP solve.

:func:`build_all` starts one ``nvcc`` per source that is not built yet, all
at once.  Nothing here runs while the module is imported, so the CPU tests
import it freely.

Flags: ``-fmad=false`` and no fast math, so each f32 operation is the IEEE
operation the plain PyTorch versions do (true division, correctly rounded
square root, no contraction into FMAs).

Launch counters, added to only by the launch paths below: ``launches``
holds K1's per mode, ``qp_launches`` K2's per (n, m) shape and
``sqp_launches`` K3's per (n1, m_own) shape.
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
           "dmpc_sqp": _PKG / "csrc" / "dmpc_sqp.cu"}
BUILD_DIR = _PKG.parent / "build" / "robogame_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_MODE_ID = {"exact": 0, "exact_export": 1, "exact_resume": 2}
launches = {mode: 0 for mode in _MODE_ID}
qp_launches: dict = {}
sqp_launches: dict = {}
build_seconds: dict = {}
_libs: dict = {}


def reset_launches() -> None:
    for mode in launches:
        launches[mode] = 0
    qp_launches.clear()
    sqp_launches.clear()


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
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
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
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        failed = []
        for name, (tmp, proc) in jobs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{err}")
                continue
            os.replace(tmp, outs[name])
            build_seconds[name] = time.perf_counter() - t0
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
    "dmpc_sqp": ("rg_dmpc_sqp", [_P] * 12 + [_I] * 7 + [_F] * 7 + [_P]),
}


def _library(name: str):
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        fn_name, argtypes = _SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


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
