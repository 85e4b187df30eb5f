"""Device operations (kernels, copies, sets) a control step over the
traced steps of the matchup (the profiler's count)."""


def read(run):
    tr = run.get("trace")
    if run["kind"] != "matchup" or not tr or not tr["ops"]:
        return None
    return tr["ops"] / tr["steps"]
