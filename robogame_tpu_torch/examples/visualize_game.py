"""Animate a binary game log (the reference's visualize_game.m, in
matplotlib; the logs are byte-compatible with the reference's MATLAB
readers).

    python -m robogame_tpu_torch.examples.visualize_game [minimal_game.log]
        [--save out.gif] [--fps 20] [--no-show] [--cpu]

The drawing runs on the host.  Like every driver of the port it takes
``--cpu`` and, without it, asks for a card, so that one command line
runs the same on a machine with and without one only when it says so.
"""

from __future__ import annotations

import argparse
import sys

from ..config import SimParams
from ..utils.visualize import animate_log
from . import add_cpu_flag, driver_device

PROG = "python -m robogame_tpu_torch.examples.visualize_game"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("log", nargs="?", default="minimal_game.log")
    ap.add_argument("--save", default=None,
                    help="write .gif (pillow) or .mp4 (ffmpeg)")
    ap.add_argument("--fps", type=float, default=20.0)
    ap.add_argument("--no-show", action="store_true")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    driver_device(args, PROG)
    animate_log(args.log, SimParams(), fps=args.fps, save=args.save,
                show=not args.no_show)
    return 0


if __name__ == "__main__":
    sys.exit(main())
