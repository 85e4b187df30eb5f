"""What every cell shares: the files a cell is made of, the run's clocks,
the profiler's reading, the metric readers and the result line.

A cell is found by name: ``BENCHMARK.json`` gives its configuration and
its traffic mix; ``configs/<config>.json`` names the entry that drives the
program (``entries/<entry>.py``) and holds the program's parameters;
``traffic/<mix>.json`` holds the mix's parameters (a schedule mix's
``family`` names ``generators/<family>.py``); ``metrics/<metric>.py``
reads one metric from the record the entry hands back (``README.md``).
"""

from __future__ import annotations

import heapq
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "robogame_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(spec: dict, workload: str):
    """(workload entry, config entry, config file, traffic mix)."""
    w = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in spec["configs"] if c["name"] == w["config"])
    cfg = json.loads((ROOT / c["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return w, c, cfg, mix


def metrics_for(spec: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: its end-to-end ones
    untraced, its per-layer ones traced."""
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in mine]


def read_metrics(metrics: list, run: dict) -> dict:
    """Each metric's reader (``metrics/<name>.py``, ``read(run)``) on the
    entry's output; a reader that finds nothing returns None and the
    metric is left out."""
    out = {}
    for m in metrics:
        mod = load_module(HERE / "metrics" / f"{m['name']}.py",
                          "bench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def use_checkout_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc libraries already live in ``build/`` beside it)."""
    base = ROOT / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def now() -> float:
    """Seconds on the clock that ``process_start`` reads (CLOCK_BOOTTIME),
    so that set-up is read on one clock from the process's start."""
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start() -> float:
    """This process's start on :func:`now`'s clock: its start time in
    ``/proc/self/stat`` (clock ticks since boot, on CLOCK_BOOTTIME)."""
    fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
    return int(fields.split()[19]) / os.sysconf("SC_CLK_TCK")


def note(msg: str) -> None:
    """A line of the run's own record on standard error."""
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class StepClock:
    """Marks on the device's stream (CUDA events; the host clock on the
    CPU, where the tests run): ``mark()`` at each policy call, ``durations``
    the seconds between consecutive marks of a series."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.series = []

    def start_series(self) -> None:
        self.series.append([])

    def mark(self) -> None:
        if self.cuda:
            import torch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.series[-1].append(ev)
        else:
            self.series[-1].append(time.perf_counter())

    def durations(self) -> list:
        """Seconds between consecutive marks, a list a series (call after
        the stream has drained)."""
        return [[a.elapsed_time(b) / 1e3 if self.cuda else b - a
                 for a, b in zip(s, s[1:])] for s in self.series]


def plain(tree, clone: bool = False):
    """A policy's carry as nested tuples of tensors (named tuples and lists
    as tuples, None kept), each tensor cloned with ``clone``: the layout a
    reference policy reads and returns."""
    import torch
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.clone() if clone else tree
    return tuple(plain(t, clone) for t in tree)


def counters() -> dict:
    """The program's launch counters (every ``*launches`` dict of
    ``robogame_tpu_torch.kernels``), as ``{"<dict>.<key>": count}``."""
    from robogame_tpu_torch import kernels
    return {f"{name}.{key}": int(v)
            for name, d in sorted(vars(kernels).items())
            if name.endswith("launches") and isinstance(d, dict)
            for key, v in d.items()}


def counter_delta(before: dict, after: dict) -> dict:
    """The counts a stretch of a run added, those that moved."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def percentile(values, q: float) -> float | None:
    """The q-th percentile (0-100), linear between order statistics."""
    import numpy as np
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


# --------------------------------------------------------------------------
# The profiler's reading
# --------------------------------------------------------------------------

def _union(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Tracer:
    """``torch.profiler`` over a stretch of a run that ``start()`` and
    ``stop()`` mark (the profiler's own start and stop), read by
    ``read()``; ``span(name)`` opens a named host span in the trace (the
    benchmark's own code: its policy, a step, a fetch)."""

    def __init__(self, cuda: bool):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.cuda = cuda
        acts = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if cuda else [])
        self.prof = profile(activities=acts)
        self.torch = torch
        self.open = None
        self.names = set()
        self.t0 = self.wall = None

    def start(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.close()
        if self.cuda:
            self.torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.prof.stop()

    def span(self, name: str) -> None:
        """Close the open span and open ``name``."""
        self.close()
        self.names.add(name)
        self.open = self.torch.autograd.profiler.record_function(name)
        self.open.__enter__()

    def close(self) -> None:
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None

    def read(self, steps: int) -> dict:
        return read_trace(self.prof, self.wall, steps, self.names)


def read_trace(prof, wall: float, steps: int, spans=()) -> dict:
    """The device operations (kernels, copies, sets) of a trace with their
    names and times, the union of their busy time over the traced wall,
    and the longest idle gaps of the device labelled by the innermost host
    operation or span running at their middle.  ``steps``: the control
    steps the trace holds; ``spans``: the benchmark's own span names (the
    profiler mirrors a host span on the device's timeline; that copy is no
    device operation)."""
    import torch
    dev, host = [], []
    for ev in prof.events():
        a, b = ev.time_range.start, ev.time_range.end     # microseconds
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.name in spans:
                continue
            dev.append((a, b, ev.name))
        else:
            host.append((a, b, ev.name))
    busy = _union([(a, b) for a, b, _ in dev]) / 1e6
    by_name: dict = {}
    count: dict = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        count[name] = count.get(name, 0) + 1
    gaps = []
    if dev:
        ivs = sorted((a, b) for a, b, _ in dev)
        end = ivs[0][1]
        for a, b in ivs[1:]:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
    labels: dict = {}
    # the innermost (shortest) host operation holding each gap's middle:
    # the gaps in order of their middles, the host operations in order of
    # their starts, a heap of those started, shortest first
    host.sort()
    heap, h = [], 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (g0 + g1)
        while h < len(host) and host[h][0] <= mid:
            a, b, name = host[h]
            heapq.heappush(heap, (b - a, b, name))
            h += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        label = heap[0][2] if heap else "(no host operation)"
        labels[label] = labels.get(label, 0.0) + (g1 - g0) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:10]]
    return {"ops": len(dev), "steps": steps, "busy_s": busy,
            "window_s": wall, "by_name": by_name, "count": count,
            "device_events": dev, "host_events": host,
            "breakdown": {"device_ops": top(by_name),
                          "idle_gaps": top(labels)}}


def kernel_seconds(tr: dict, fragment: str) -> float:
    """Device seconds of the traced operations whose name holds
    ``fragment``."""
    return sum(v for k, v in tr["by_name"].items() if fragment in k)


def kernel_count(tr: dict, fragment: str) -> int:
    """Traced device operations whose name holds ``fragment``."""
    return sum(v for k, v in tr["count"].items() if fragment in k)


# --------------------------------------------------------------------------
# The device and the result line
# --------------------------------------------------------------------------

def device_info(count: int, peak: int, cuda: bool) -> dict:
    import torch
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    return {"platform": "gpu" if cuda else "cpu", "kind": kind,
            "count": count, "memory_peak_bytes": int(peak)}


def finish(run: dict, checks: list, metrics: dict, trace_on: bool) -> int:
    """Print the numbers compared on standard error and the result as the
    last line of standard output; exit code."""
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    correct = all(v <= lim for _, v, lim in checks)
    result = {"correct": correct, "attempted": run["attempted"],
              "failed": run["failed"] if correct else max(1, run["failed"]),
              "metrics": metrics, "device": dict(run["device"])}
    if trace_on and run.get("trace"):
        tr = run["trace"]
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = tr["breakdown"]
    result["check"] = {name: {"value": v, "limit": lim}
                       for name, v, lim in checks}
    print(json.dumps(result), flush=True)
    for name, v, lim in checks:
        print(f"check {name}: {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    print(f"correct: {correct}", file=sys.stderr, flush=True)
    return 0
