"""``step_ms_p95`` on rank 0 of a sweep over several cards (the cards'
processes share the host's cores)."""

from benchmark.harness import percentile


def read(run):
    if run["world"] == 1:
        return None
    steps = [d for series in run["step_s"] for d in series]
    p = percentile(steps, 95)
    return None if p is None else p * 1e3
