"""The 95th percentile, over every control step of the window, of one
step's time: the policy, ``step_batch`` and the two-phase host fetch,
between the marks the benchmark's policy puts on the card's stream (CUDA
events) at each call (a sweep's last step ends at ``monte_carlo()``'s
return).  One card."""

from benchmark.harness import percentile


def read(run):
    if run["world"] != 1:
        return None
    steps = [d for series in run["step_s"] for d in series]
    p = percentile(steps, 95)
    return None if p is None else p * 1e3
