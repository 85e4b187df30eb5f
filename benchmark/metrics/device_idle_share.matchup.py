"""1 minus the union of the device's busy time over the wall of the
matchup's traced steps (the profiler's trace)."""


def read(run):
    tr = run.get("trace")
    if run["kind"] != "matchup" or not tr or not tr["ops"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
