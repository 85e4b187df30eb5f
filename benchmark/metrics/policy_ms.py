"""The policy's time a control step: the span between CUDA events put on
the card's stream just before and just after the benchmark's call of the
matchup policy, averaged over the window's steps."""


def read(run):
    if run["kind"] != "matchup" or not run.get("policy_s"):
        return None
    return 1e3 * sum(run["policy_s"]) / len(run["policy_s"])
