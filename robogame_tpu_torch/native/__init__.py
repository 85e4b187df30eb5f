"""The asynchronous C++ game logger (``logger.cpp``), bound with ctypes.

Host-side writes stage into a buffer that a background thread flushes to
disk, so a control loop feeding the GPU never blocks on a log write.  The
shared library is built with ``g++`` at first use into
``build/robogame_tpu_torch/`` beside the package (named by a hash of the
source and flags); where there is no ``g++``, :func:`available` is False
and ``utils.gamelog.GameLogWriter`` writes with numpy instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "logger.cpp"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "robogame_tpu_torch")
FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_lib = None
_failed = False
_lock = threading.Lock()


def _out_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(FLAGS).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"librobogame_logger-{digest}.so"


def _build() -> Path | None:
    out = _out_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([gxx, *FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return None
    os.replace(tmp, out)
    return out


def _load():
    """The library (built if need be), or None where it cannot be built."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = _build()
        try:
            lib = ctypes.CDLL(str(path)) if path is not None else None
        except OSError:
            lib = None
        if lib is None:
            _failed = True
            return None
        lib.rg_logger_open.restype = ctypes.c_void_p
        lib.rg_logger_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.rg_logger_write.restype = ctypes.c_int
        lib.rg_logger_write.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_double),
                                        ctypes.c_uint64]
        lib.rg_logger_flush.argtypes = [ctypes.c_void_p]
        lib.rg_logger_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeLogger:
    """Asynchronous append-only binary logger over the C++ library.

    Raises OSError if the library cannot be built or loaded; callers that
    want the numpy writer instead check :func:`available` first."""

    def __init__(self, path: str, buf_doubles: int = 1 << 16):
        lib = _load()
        if lib is None:
            raise OSError("native logger library unavailable")
        self._lib = lib
        self._h = lib.rg_logger_open(os.fsencode(path), buf_doubles)
        if not self._h:
            raise OSError(f"cannot open log file {path}")

    def write(self, arr) -> None:
        a = np.ascontiguousarray(arr, dtype=np.float64).reshape(-1)
        p = a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        if self._lib.rg_logger_write(self._h, p, a.size) != 0:
            raise OSError("native logger write failed")

    def flush(self) -> None:
        if self._h:
            self._lib.rg_logger_flush(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.rg_logger_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
