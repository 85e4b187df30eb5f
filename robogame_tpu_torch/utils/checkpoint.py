"""Checkpoint and resume for long sweeps.

Counterpart of the JAX package's ``utils/checkpoint.py``.  A sweep's whole
state is one nest (the batched :class:`..state.GameState` and any policy
carry), so a checkpoint is that nest on disk: one ``.npz`` holding the
leaves as numpy arrays and a JSON header (the nest's shape, the leaf
count, the caller's metadata), readable with numpy alone.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .tree import leaves, structure, unflatten


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_checkpoint(path: str, tree, meta: dict | None = None) -> None:
    """Save a nest of named tuples, tuples, lists and dicts of tensors
    (pulled to the host) to ``path``, replacing it atomically."""
    flat = leaves(tree)
    arrays = {f"leaf_{i}": _host(a) for i, a in enumerate(flat)}
    header = dict(treedef=structure(tree), n_leaves=len(flat),
                  meta=meta or {})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __header__=json.dumps(header), **arrays)
    os.replace(tmp, path)       # atomic on POSIX


def _like(a: np.ndarray, ref):
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(a).to(device=ref.device, dtype=ref.dtype)
    if isinstance(ref, (bool, int, float)):
        return type(ref)(a.item())
    return a


def load_checkpoint(path: str, like):
    """Restore into the shape of ``like``, each leaf on the device and in
    the dtype of ``like``'s leaf.  Returns (tree, meta)."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(str(z["__header__"]))
        saved = [z[f"leaf_{i}"] for i in range(header["n_leaves"])]
    refs = leaves(like)
    if len(refs) != len(saved):
        raise ValueError(
            f"checkpoint has {len(saved)} leaves, target structure "
            f"expects {len(refs)}")
    return (unflatten(like, [_like(a, r) for a, r in zip(saved, refs)]),
            header["meta"])


def checkpointed_scan(step_fn, state, n_steps: int, path: str,
                      every: int = 200, meta: dict | None = None):
    """Run ``step_fn`` (state -> state) ``n_steps`` times on the host in
    chunks of ``every`` steps, writing a checkpoint to ``path`` after each
    chunk (its meta holds ``step``, the steps done).  Resumes from
    ``path`` where it exists (the same nest required)."""
    start = 0
    if os.path.exists(path):
        state, saved = load_checkpoint(path, state)
        start = int(saved.get("step", 0))
    done = start
    while done < n_steps:
        k = min(every, n_steps - done)
        for _ in range(k):
            state = step_fn(state)
        done += k
        m = dict(meta or {})
        m["step"] = done
        save_checkpoint(path, state, m)
    return state
