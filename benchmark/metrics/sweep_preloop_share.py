"""The share of the window between each ``monte_carlo()`` call and its
first policy call (the starts and, over a mesh, the padding and the
sharding), summed over the window's sweeps (host clock, the benchmark's
own timestamps in ``run["marks"]``)."""


def read(run):
    if run["kind"] != "sweep" or not run["marks"]:
        return None
    pre = sum(m["policy"][0] - m["call"] for m in run["marks"]
              if m["policy"])
    return 100.0 * pre / run["window_s"]
