"""The plain reference against the program's own plain versions at tiny
sizes on the CPU: the same starts, the same step (bitwise: the reference
is a frozen copy), the same policy."""

import dataclasses
import json

import pytest
import torch

from benchmark import check as chk
from benchmark import generate, harness
from benchmark.reference import mpc as ref_mpc
from benchmark.reference import physics, starts


def _cfg(name):
    return json.loads((harness.HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("family", ["uniform_b32768", "corner_b32768"])
def test_step_equals_the_programs_plain_step(family):
    from robogame_tpu_torch.config import SimParams
    from robogame_tpu_torch.parallel.monte_carlo import (McParams,
                                                         _initial_states)
    from robogame_tpu_torch.physics.step import step_batch
    cfg = _cfg("mc_exact_sweep")
    mix = json.loads((harness.HERE / "traffic" / f"{family}.json").read_text())
    p = SimParams(**cfg["SimParams"])
    B, n = 12, 12
    s = _initial_states(p, McParams(num_runs=B, randomize_x0=True),
                        device="cpu")
    table, hold = generate.schedule_table(dict(mix, games=B), 3, 0, 400,
                                          "cpu")
    for k in range(n):
        u = table[:, k // hold]
        nxt = step_batch(s, u, p, device="cpu")
        got = physics.step(dataclasses.asdict(p), s.x, s.score, s.damage,
                           s.t, u)
        for a, b in zip(got, nxt[:4]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        s = nxt


def test_starts_equal_the_programs():
    from robogame_tpu_torch.config import SimParams
    from robogame_tpu_torch.parallel.monte_carlo import (McParams,
                                                         _initial_states)
    from robogame_tpu_torch.state import initial_state
    cfg = _cfg("mc_exact_sweep")
    p = SimParams(**cfg["SimParams"])
    m = cfg["McParams"]
    mc = McParams(num_runs=20, T=m["T"], randomize_x0=True,
                  x0_pos_range=tuple(m["x0_pos_range"]),
                  x0_vel_range=m["x0_vel_range"])
    prog = _initial_states(p, mc, device="cpu")
    games = [0, 3, 19]
    ref = starts.sweep_starts(cfg["SimParams"], m, games)
    for a, b in zip(ref, prog):
        assert torch.equal(a, b[games])
    x0 = torch.tensor([[0.5, -0.25, 1.0, -2.0], [0.0, 0.1, 0.2, 0.3]])
    prog = initial_state(p, x0_puck=x0, seed=[7, 9], device="cpu")
    for a, b in zip(starts.given_starts(cfg["SimParams"], x0, [7, 9]), prog):
        assert torch.equal(a, b)


def test_policy_equals_the_programs_plain_policy():
    from robogame_tpu_torch.agents.dmpc_team import dmpc_matchup
    from robogame_tpu_torch.config import SimParams
    from robogame_tpu_torch.physics.step import step_batch
    from robogame_tpu_torch.state import initial_state
    cfg = _cfg("matchup_dmpc_cmpc")
    p = SimParams(**cfg["SimParams"])
    B = 3
    x0, seeds = generate.closed_loop_starts(
        {"games": B, "pos_range": [1.0, 0.5], "vel_range": 2.0}, 4, 0, "cpu")
    s = initial_state(p, x0_puck=x0, seed=seeds.tolist(), device="cpu")
    policy, ps = dmpc_matchup(p, B, "cmpc", device="cpu")
    for _ in range(2):
        ta, tb = ps
        d = tuple(torch.stack([a, b], 1) for a, b in zip(ta.attacker,
                                                        ta.defender))
        u_ref, d_new, c_new = ref_mpc.matchup_policy(
            s.x, d, tuple(tb), cfg["SimParams"], cfg["MpcParams"],
            cfg["StrategyParams"])
        ps, u = policy(ps, s)
        assert torch.equal(u, u_ref)
        assert torch.equal(ps[1].U, c_new[0])
        assert torch.equal(torch.stack([ps[0].attacker.U, ps[0].defender.U],
                                       1), d_new[0])
        s = step_batch(s, u, p, device="cpu")


def test_pairing_reference_answers_in_the_programs_carry_layout():
    from robogame_tpu_torch.config import SimParams
    from robogame_tpu_torch.state import initial_state
    from benchmark.entries import matchup
    from benchmark.reference import dmpc_vs_cmpc
    cfg = _cfg("matchup_dmpc_cmpc")
    p = SimParams(**cfg["SimParams"])
    B = 3
    x0, seeds = generate.closed_loop_starts(
        {"games": B, "pos_range": [1.0, 0.5], "vel_range": 2.0}, 6, 0, "cpu")
    s = initial_state(p, x0_puck=x0, seed=seeds.tolist(), device="cpu")
    policy, ps = matchup.build_policy(cfg, p, B, torch.device("cpu"))
    assert matchup.reference_policy(cfg) is dmpc_vs_cmpc
    for _ in range(2):
        u_ref, c_ref = dmpc_vs_cmpc.policy(s.x, harness.plain(ps), cfg)
        ps, u = policy(ps, s)
        assert torch.equal(u, u_ref)
        got = harness.plain(ps)
        assert len(chk.leaves(got)) == len(chk.leaves(c_ref)) == 9
        for a, b in zip(chk.leaves(got), chk.leaves(c_ref)):
            assert torch.equal(a, b)


def test_lower_precision_moves_every_stage():
    cfg = _cfg("matchup_dmpc_cmpc")
    sp = cfg["SimParams"]
    x0 = torch.tensor([[0.5, -0.25, 1.0, -2.0], [0.0, 0.1, 0.2, 0.3]])
    s = starts.given_starts(sp, x0, [1, 2])
    u = torch.full((2, 4, 2), 3.0)
    hi = physics.step(sp, *s[:4], u)
    lo = physics.step(sp, *s[:4], u, dtype=torch.bfloat16)
    assert lo[0].dtype == torch.bfloat16
    assert float((hi[0] - lo[0].float()).abs().max()) > 1e-3
