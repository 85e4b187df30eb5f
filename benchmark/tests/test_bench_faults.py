"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, a small cell driven on the CPU with the
program's step (or policy, or gather) patched to a fault."""

import os
import tempfile

import pytest
import torch
import torch.multiprocessing as mp

from benchmark.tests import _small


def _unchanged(real):
    return lambda s, u, p, device="cuda", **kw: s


def _half(real):
    def step(s, u, p, device="cuda", **kw):
        new = real(s, u, p, device=device, **kw)
        h = s.x.shape[0] // 2
        return type(s)(*(torch.cat([a[:h], b[h:]]) for a, b in zip(new, s)))
    return step


def _altered(real):
    def step(s, u, p, device="cuda", **kw):
        new = real(s, u, p, device=device, **kw)
        x = new.x.clone()
        x[:, 4, 0] += 1e-3                 # every game's puck, a millimetre
        return new._replace(x=x)
    return step


FAULTS = {"unchanged": _unchanged, "half_batch": _half, "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", [_small.SWEEP, _small.MATCHUP])
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch, capsys):
    import importlib
    mc = importlib.import_module("robogame_tpu_torch.parallel.monte_carlo")
    st = importlib.import_module("robogame_tpu_torch.physics.step")
    real = st.step_batch
    monkeypatch.setattr(mc, "step_batch", FAULTS[fault](real))
    monkeypatch.setattr(st, "step_batch", FAULTS[fault](real))
    code, res = _small.run(cell, capsys=capsys)
    assert code == 0 and res["correct"] is False and res["failed"] > 0


def test_an_altered_policy_answer_is_not_correct(monkeypatch, capsys):
    import importlib
    team = importlib.import_module("robogame_tpu_torch.agents.dmpc_team")
    real = team.dmpc_matchup

    def matchup(*a, **kw):
        policy, ps = real(*a, **kw)

        def altered(carry, states):
            carry, u = policy(carry, states)
            return carry, u + 0.05
        return altered, ps
    monkeypatch.setattr(team, "dmpc_matchup", matchup)
    code, res = _small.run(_small.MATCHUP, capsys=capsys)
    assert code == 0 and res["correct"] is False
    assert res["check"]["policy_miss"]["value"] > 0.5


def test_a_carry_returned_unchanged_is_not_correct(monkeypatch, capsys):
    import importlib
    team = importlib.import_module("robogame_tpu_torch.agents.dmpc_team")
    real = team.dmpc_matchup

    def matchup(*a, **kw):
        policy, ps = real(*a, **kw)

        def stale(carry, states):
            _, u = policy(carry, states)
            return carry, u                 # the warm state never moves
        return stale, ps
    monkeypatch.setattr(team, "dmpc_matchup", matchup)
    code, res = _small.run(_small.MATCHUP, capsys=capsys)
    assert code == 0 and res["correct"] is False
    assert res["check"]["carry_miss"]["value"] > 0.5
    assert res["check"]["policy_miss"]["value"] == 0.0


def test_the_unbroken_cells_are_correct(capsys):
    for cell in (_small.SWEEP, _small.CORNER, _small.MATCHUP):
        code, res = _small.run(cell, capsys=capsys)
        assert code == 0 and res["correct"] is True, res


def _mesh_rank(rank, path, broken, queue):
    import importlib
    mc = importlib.import_module("robogame_tpu_torch.parallel.monte_carlo")
    if broken:                   # each rank keeps its own slice only
        mc._gather = lambda a, mesh, dim: torch.cat([a] * mesh.size(), dim)
    import io
    import contextlib
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        # 2 s of play: the games' scores and damage part by then
        code, _ = _small.run(_small.MESH, rank=rank, chips=2,
                             rendezvous=path, T=2.0, seconds=0.1)
    queue.put((rank, code, buf.getvalue()))


@pytest.mark.parametrize("broken", [False, True])
def test_the_exchange_between_cards_left_out(broken):
    import json
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    path = os.path.join(tempfile.mkdtemp(), "rendezvous")
    procs = [ctx.Process(target=_mesh_rank, args=(r, path, broken, q))
             for r in range(2)]
    for p in procs:
        p.start()
    got = dict((r, (c, o)) for r, c, o in (q.get(timeout=300)
                                            for _ in procs))
    for p in procs:
        p.join(60)
        assert not p.is_alive()
    assert all(c == 0 for c, _ in got.values())
    res = json.loads(got[0][1].strip().splitlines()[-1])
    assert res["correct"] is (not broken)
    if broken:
        assert res["check"]["final_gap"]["value"] > 0
