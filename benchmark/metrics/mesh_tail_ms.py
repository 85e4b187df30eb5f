"""Rank 0's time from its last policy call of a sweep to
``monte_carlo()``'s return (the last step, the wait for the slowest rank,
the all_gather and the cut back), a sweep on average, between the marks on
the card's stream."""


def read(run):
    if run["kind"] != "sweep" or run["world"] == 1 or not run["step_s"]:
        return None
    tails = [series[-1] for series in run["step_s"] if series]
    return 1e3 * sum(tails) / len(tails)
