"""Two-phase compact-and-resume in the port equals the one-phase step
bitwise (the plain PyTorch version of K1), each game's activity (meta
row 3) included, on each of its three paths:
the resume budget covers the whole batch, the pending games overflow the
budget (full-batch resume), and the pending games are compacted into the
budget (gather / resume / scatter).  The compaction budget is
B / compact_frac rounded up to whole 32-game CUDA blocks, so the batches
here are 32 and 64 games."""

import os
import sys

import pytest
import torch

import robogame_tpu_torch as rt
from robogame_tpu_torch.parallel.monte_carlo import _initial_states
from robogame_tpu_torch.physics import exact_step as tex
from _port_env import port_module  # noqa: F401  (autouse fixture)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from dist_equiv import make_sched  # noqa: E402


B_MAX = 64
P1 = rt.SimParams(dtype="float32", engine="pallas_exact", two_phase=False)


def _states(B):
    """Random puck starts, seeds 1..B (the MC workload's initial states)."""
    mc = rt.McParams(num_runs=B, randomize_x0=True)
    return _initial_states(rt.SimParams(), mc, device="cpu")


@pytest.fixture(scope="module")
def one_phase():
    """The pre-ground states, the one-phase step's states 6 steps on with
    each step's activity, and the schedules, per (family, pre) for B_MAX
    games.  A smaller case takes
    the first B games: the same seeds and schedules (make_sched draws the
    games in order), and games step independently, so the two corner cases
    share one one-phase run."""
    runs = {}

    def get(family, pre, B):
        if (family, pre) not in runs:
            us = torch.from_numpy(make_sched(family, B_MAX, pre + 6, seed=5))
            s = _states(B_MAX)
            for k in range(pre):
                s = rt.step_batch(s, us[k], P1, device="cpu")
            s1, acts = s, []
            for k in range(pre, pre + 6):
                s1, a = rt.step_batch(s1, us[k], P1, device="cpu",
                                      with_activity=True)
                acts.append(a)
            runs[family, pre] = (s, s1, torch.stack(acts), us)
        s, s1, acts, us = runs[family, pre]
        first = lambda st: type(st)(*(a[:B] for a in st))
        return first(s), first(s1), acts[:, :B], us[:, :B]

    return get


@pytest.mark.parametrize("B, frac, family, pre, path", [
    (32, 4, "corner", 24, "cover"),
    (64, 2, "corner", 24, "overflow"),
    (64, 2, "uniform", 20, "compact"),
])
def test_twophase_bitwise_equals_one_phase(monkeypatch, one_phase, B, frac,
                                           family, pre, path):
    p2 = P1.replace(two_phase=True, phase1_iters=1, compact_frac=frac)
    s, s1, acts1, us = one_phase(family, pre, B)

    resumes, pending = [], []
    call = tex._kernel_call

    def spy(planes, *a, **kw):
        out = call(planes, *a, **kw)
        if kw.get("mode") == "exact_resume":
            resumes.append(planes[0].shape[1])
        if kw.get("mode") == "exact_export":
            pending.append(int(out[0][1][5].sum()))
        return out

    monkeypatch.setattr(tex, "_kernel_call", spy)
    s2, acts2 = s, []
    for k in range(pre, pre + 6):
        s2, a = rt.step_batch(s2, us[k], p2, device="cpu",
                              with_activity=True)
        acts2.append(a)
    for a, b in zip((*s1, acts1), (*s2, torch.stack(acts2))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    K = tex._compact_lanes(B, p2)
    if path == "cover":
        assert K == B and resumes == [B] * 6 and max(pending) > 0
    elif path == "overflow":
        assert K < B and max(pending) > K and B in resumes
    else:
        assert K < B and resumes == [K] * 6 and 0 < max(pending) <= K
