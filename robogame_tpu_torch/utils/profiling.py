"""Tracing, phase timing and the one-line metric.

Counterpart of the JAX package's ``utils/profiling.py``:

* :func:`trace` -- a ``torch.profiler`` trace (the card's kernels too
  where one is present), written for TensorBoard;
* :class:`PhaseTimer` -- host wall time and item counts per phase; the
  caller synchronizes the device inside a phase
  (``torch.cuda.synchronize()``), as JAX's caller blocks;
* :func:`counters_line` -- one JSON line of a metric (the bench.py
  convention).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Trace the host and, where a card is present, its kernels with
    ``torch.profiler``; the trace goes into ``logdir`` (by default
    ``robogame_trace`` in the temporary directory) as a TensorBoard
    ``*.pt.trace.json``.  Yields the directory."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "robogame_trace")
    act = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        act.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=act,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    with prof:
        yield logdir


class PhaseTimer:
    """Accumulates host wall time and item counts per phase.

    >>> pt = PhaseTimer()
    >>> with pt.phase("rollout", items=B * n_steps):
    ...     out = run(states); torch.cuda.synchronize()
    >>> pt.rates()["rollout"]   # items/s
    """

    def __init__(self):
        self._t: Dict[str, float] = {}
        self._n: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._t[name] = self._t.get(name, 0.0) + dt
            self._n[name] = self._n.get(name, 0) + items

    def seconds(self) -> Dict[str, float]:
        return dict(self._t)

    def rates(self) -> Dict[str, float]:
        return {k: (self._n[k] / t if t > 0 else 0.0)
                for k, t in self._t.items()}

    def report(self) -> str:
        parts = []
        for k, t in sorted(self._t.items()):
            r = self._n[k] / t if t > 0 and self._n[k] else None
            parts.append(f"{k}: {t:.3f}s" +
                         (f" ({r:,.0f}/s)" if r else ""))
        return "  ".join(parts)


def counters_line(metric: str, value: float, unit: str,
                  vs_baseline: float | None = None) -> str:
    """The bench.py one-JSON-line convention."""
    d = {"metric": metric, "value": round(float(value), 1), "unit": unit}
    if vs_baseline is not None:
        d["vs_baseline"] = round(float(vs_baseline), 2)
    return json.dumps(d)
