"""1 minus the union of the device's busy time over the wall of the traced
sweep's step loop, from its first policy call to the fetch of its scores
(the profiler's trace; the starts before it run on the host alone and are
read by ``sweep_preloop_share``).  One card: over a mesh NCCL's
all_gather counts busy while it waits for the slowest rank, and rank 0's
wall is no other rank's, so the reading there is no idle share."""


def read(run):
    tr = run.get("trace")
    if run["kind"] != "sweep" or run["world"] != 1 or not tr or \
            not tr["ops"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
