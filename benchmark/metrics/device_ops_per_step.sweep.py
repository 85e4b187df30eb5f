"""Device operations (kernels, copies, sets) a control step in the traced
sweep (the profiler's count over the sweep's steps; on rank 0 over a
mesh)."""


def read(run):
    tr = run.get("trace")
    if run["kind"] != "sweep" or not tr or not tr["ops"]:
        return None
    return tr["ops"] / tr["steps"]
