"""Monte-Carlo sweep WITHOUT the CBF filter (the reference's
mc_example_2.py): :mod:`.mc_example_1` with ``--no-cbf``.

    python -m robogame_tpu_torch.examples.mc_example_2 [--runs 4] [--T 10]
        [--out mc_out_torch] [--no-logs] [--cpu]
"""

from __future__ import annotations

import sys

from . import mc_example_1

PROG = "python -m robogame_tpu_torch.examples.mc_example_2"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    return mc_example_1.main([*argv, "--no-cbf"], prog=PROG)


if __name__ == "__main__":
    sys.exit(main())
