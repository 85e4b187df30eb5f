"""The plain PyTorch versions of the kernels run without autograd's
bookkeeping: nothing in the simulator is differentiated, and on small CPU
tensors the per-operation cost of recording versions and views is a good
share of a plain version's time."""

from __future__ import annotations

import functools

import torch


def _ordinary(out):
    """Tensors made in inference mode, cloned into ordinary tensors (which
    callers may update in place); tuples and named tuples rebuilt."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, tuple):
        parts = [_ordinary(a) for a in out]
        return type(out)(*parts) if hasattr(out, "_fields") else tuple(parts)
    return out


def plain_version(fn):
    """Decorator for a kernel's plain PyTorch version: the body runs in
    ``torch.inference_mode`` and its results come back as ordinary
    tensors.  The arithmetic is untouched."""
    @functools.wraps(fn)
    def run(*args, **kw):
        with torch.inference_mode():
            out = fn(*args, **kw)
        return _ordinary(out)
    return run
