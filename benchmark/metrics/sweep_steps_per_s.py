"""Game control-steps of open-loop sweeps a second: every game-step of
every whole ``monte_carlo()`` call of the window, over the window's wall
(host clock), the host fetch of each sweep's scores included."""


def read(run):
    if run["kind"] != "sweep":
        return None
    return run["game_steps"] / run["window_s"]
