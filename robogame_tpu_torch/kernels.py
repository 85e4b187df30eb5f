"""Build, bind and launch the port's hand-written CUDA kernels.

``csrc/exact_step.cu`` (K1, the event-order-exact control step) is compiled
at first use by ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface under ``build/robogame_tpu_torch/`` beside the package, and bound
with ``ctypes``.  Nothing here runs while the module is imported, so the
CPU tests import it freely.

Flags: ``-fmad=false`` and no fast math, so each f32 operation is the IEEE
operation the plain PyTorch version does (true division, correctly rounded
square root, no contraction into FMAs).

``launches`` counts the kernel's launches per mode; only the launch path
below adds to it.
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
SOURCE = _PKG / "csrc" / "exact_step.cu"
BUILD_DIR = _PKG.parent / "build" / "robogame_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_MODE_ID = {"exact": 0, "exact_export": 1, "exact_resume": 2}
launches = {mode: 0 for mode in _MODE_ID}
build_seconds = None
_lib = None


def reset_launches() -> None:
    for mode in launches:
        launches[mode] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(cand)


def build() -> Path:
    """Compile K1 unless a library built from this source and these flags
    exists; returns its path."""
    global build_seconds
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libexact_step-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rg_exact_step.argtypes = [p] * 13 + [i, i, i, i, p]
        lib.rg_exact_step.restype = i
        _lib = lib
    return _lib


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
        err = _library().rg_exact_step(
            consts.ctypes.data, _ptr(M6), _ptr(x), _ptr(u), _ptr(meta),
            _ptr(dmg), _ptr(noise), _ptr(rnoise), _ptr(grid),
            _ptr(carry_in if mode == "exact_resume" else None), _ptr(xout),
            _ptr(aux), _ptr(carry), B, K1, _MODE_ID[mode], int(cap),
            stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    launches[mode] += 1
    return xout, aux, grid, carry
