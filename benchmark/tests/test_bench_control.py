"""The control at a size a test run holds: the program's readings within
the cell's limits, the control's (the plain reference in bfloat16 in the
program's place) beyond at least one of them and above the program's on
every number."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests import _small


@pytest.mark.parametrize("cell", [_small.SWEEP, _small.MATCHUP])
def test_the_control_fails_and_the_program_passes(cell):
    r = control.readings(harness.bench_spec(), cell, 2 ** 31 + 77, 0.3,
                         device=torch.device("cpu"), sizes=_small.sizes)
    assert all(v <= r["limits"][n] for n, v in r["program"].items())
    assert any(v > r["limits"][n] for n, v in r["control"].items())
    assert all(r["control"][n] > r["program"][n] for n in r["program"])
