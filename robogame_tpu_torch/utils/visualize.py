"""Game visualization and Monte-Carlo result analysis.

The port's copy of the JAX package's ``utils/visualize.py``, on the
port's game logs and parameters (the reference's offline MATLAB layer):

* :func:`animate_log` -- arena animation from a 29-field binary log
  (the reference's visualize_game.m: the log interpolated to a fixed FPS,
  the arena, goals, players and puck, optional video export);
* :func:`interpret_mc_results` -- score and damage histograms over a
  Monte-Carlo output directory (the reference's interpret_mc_results.m).

matplotlib is imported inside the functions that draw, so batch jobs, and
machines without it, never import it.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..config import SimParams
from .gamelog import read_log

# log position-field layout: t, scoreA, scoreB, then (x, y) of
# puck, A1, A2, B1, B2 (the reference's GameSim log)
_ENTITIES = ("puck", "A1", "A2", "B1", "B2")
_COLORS = ("black", "tab:red", "tab:orange", "tab:blue", "tab:cyan")


def _interp_log(log: np.ndarray, fps: float):
    """Resample a (T, 29) log to a fixed frame rate."""
    t = log[:, 0]
    t_out = np.arange(t[0], t[-1], 1.0 / fps)
    cols = [np.interp(t_out, t, log[:, k]) for k in range(log.shape[1])]
    return t_out, np.stack(cols, axis=1)


def animate_log(path: str, params: SimParams | None = None,
                fps: float = 20.0, save: str | None = None,
                show: bool = True, fields: int = 29):
    """Animate a binary game log; optionally save to a video/GIF file.

    As the reference's visualize_game.m: 20 FPS playback, the arena, goal
    lines, entity circles and the score.
    ``fields=13`` reads the damage-less layout used by the reference's
    visualize_dmpc_test.m.
    """
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt
    from matplotlib.patches import Circle, Rectangle

    params = params or SimParams()
    log = read_log(path, fields=fields)
    if log.shape[0] < 2:
        raise ValueError(f"log {path} has {log.shape[0]} records")
    t_out, frames = _interp_log(log, fps)

    hx, hy = params.arena_x / 2.0, params.arena_y / 2.0
    gh = params.goal_height / 2.0
    fig, ax = plt.subplots(figsize=(10, 5.5))
    ax.set_xlim(-hx - 0.5, hx + 0.5)
    ax.set_ylim(-hy - 0.5, hy + 0.5)
    ax.set_aspect("equal")
    ax.add_patch(Rectangle((-hx, -hy), 2 * hx, 2 * hy, fill=False,
                           lw=2, ec="k"))
    for sx in (-1, 1):
        ax.plot([sx * hx, sx * hx], [-gh, gh], lw=6,
                color="tab:green", alpha=0.6)

    radii = (params.puck_radius,) + (params.player_radius,) * 4
    circles = []
    for name, color, r in zip(_ENTITIES, _COLORS, radii):
        c = Circle((0, 0), r, color=color, label=name)
        ax.add_patch(c)
        circles.append(c)
    ax.legend(loc="upper right", fontsize=8)
    title = ax.set_title("")

    def draw(k):
        row = frames[k]
        for e, c in enumerate(circles):
            c.center = (row[3 + 2 * e], row[4 + 2 * e])
        title.set_text(f"t = {t_out[k]:5.2f} s    "
                       f"A {row[1]:.0f} : {row[2]:.0f} B")
        return circles + [title]

    anim = animation.FuncAnimation(fig, draw, frames=len(t_out),
                                   interval=1000.0 / fps, blit=False)
    if save:
        writer = ("pillow" if save.endswith(".gif") else "ffmpeg")
        anim.save(save, writer=writer, fps=int(fps))
    if show:
        plt.show()
    plt.close(fig)
    return save or anim


def animate_mc_run(out_dir: str, run: int, fps: float = 20.0,
                   save: str | None = None, show: bool = True):
    """Animate one run of a Monte-Carlo sweep using its configuration.txt
    metadata (the reference's visualize_mc_game.m)."""
    config, _, _ = load_mc_results(out_dir)
    params = SimParams(dt=config["dt"],
                       winning_score=int(config["winning_score"]),
                       tau_puck=config["tau_puck"],
                       tau_player=config["tau_player"],
                       player_mass=config["player_mass"],
                       puck_mass=config["puck_mass"])
    return animate_log(os.path.join(out_dir, f"mc_run_{run}.log"), params,
                       fps=fps, save=save, show=show)


def load_mc_results(out_dir: str):
    """Read configuration.txt + per-run logs from a Monte-Carlo output
    directory; returns (config dict, final scores (R, 2), damage (R, 16))."""
    cfg_path = os.path.join(out_dir, "configuration.txt")
    keys = ["num_runs", "T", "dt", "winning_score", "x0", "y0", "vx0",
            "vy0", "noise", "tau_puck", "tau_player", "player_mass",
            "puck_mass"]
    with open(cfg_path) as f:
        vals = [float(line) for line in f]
    config = dict(zip(keys, vals))
    scores, damage = [], []
    for p in sorted(glob.glob(os.path.join(out_dir, "mc_run_*.log"))):
        log = read_log(p)
        scores.append(log[-1, 1:3])
        damage.append(log[-1, 13:29])
    return config, np.asarray(scores), np.asarray(damage)


def interpret_mc_results(out_dir: str, save: str | None = None,
                         show: bool = True):
    """Score and pairwise-damage histograms across runs (the reference's
    interpret_mc_results.m)."""
    import matplotlib.pyplot as plt

    config, scores, damage = load_mc_results(out_dir)
    fig, axes = plt.subplots(1, 3, figsize=(14, 4))
    bins = np.arange(-0.5, config["winning_score"] + 1.5)
    axes[0].hist(scores[:, 0], bins=bins, alpha=0.7, label="team A")
    axes[0].hist(scores[:, 1], bins=bins, alpha=0.7, label="team B")
    axes[0].set_title(f"final scores over {len(scores)} runs")
    axes[0].legend()
    axes[1].hist(scores[:, 0] - scores[:, 1], bins=20)
    axes[1].set_title("score differential (A - B)")
    axes[2].hist(damage.sum(axis=1), bins=20)
    axes[2].set_title("total damage per run")
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=120)
    if show:
        plt.show()
    plt.close(fig)
    return config, scores, damage
