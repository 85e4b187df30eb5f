"""Game control-steps of a closed-loop matchup a second: every game-step
of the window (both teams' solves and the physics) over its wall (host
clock)."""


def read(run):
    if run["kind"] != "matchup":
        return None
    return run["game_steps"] / run["window_s"]
