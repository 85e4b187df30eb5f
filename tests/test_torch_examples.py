"""The port's example drivers and harness entry, run in this process on the
CPU (``--cpu``), as tests/test_examples.py runs the JAX package's:

* ``run_collisions`` over the first 100 steps of its built-in schedule in
  f64 on the event engine, against JAX's ``scripted_rollout``: scores
  equal, positions within 1e-9 (the golden logs' own hold,
  tests/test_torch_parity.py);
* ``mc_example_1`` and ``_2`` at 2 runs x 0.5 s: configuration.txt equal
  to the text JAX's ``write_configuration`` writes for the same
  parameters, a log a game of the JAX example's shape;
* ``matchups``: all six pairings at 2 games x 1 step; its records' keys
  and values equal those JAX's ``run_matchup`` makes of the same scores
  and damage; its invariants on records that keep and break each;
* ``run_sim``, ``run_dmpc_sim``, ``run_centralized_sim`` for a few steps
  with their logs, and ``visualize_game`` over one of them; the bank shot
  of ``bounce_kick_demo`` in f32 (a goal);
* ``bench_sweep`` and ``bench_mpc``'s three modes at tiny sizes;
* ``mc_scaling`` and ``graft_entry`` (``entry`` and
  ``dryrun_multichip``) in one Gloo process; marked slow, the dry run at
  two and four processes and the sweep over 1, 2 and 4;
* every driver without ``--cpu`` on this machine, which has no card:
  exits non-zero.
"""

import importlib
import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogame_tpu.config import SimParams as JParams
from robogame_tpu.parallel.monte_carlo import McParams as JMcParams
from robogame_tpu.parallel.monte_carlo import write_configuration
from robogame_tpu.physics.rollout import scripted_rollout as j_rollout
from robogame_tpu.state import initial_state as j_initial_state

from robogame_tpu_torch import graft_entry
from robogame_tpu_torch.examples import (bench_mpc, bench_sweep,
                                         bounce_kick_demo, matchups,
                                         mc_example_1, mc_scaling,
                                         run_collisions)
from robogame_tpu_torch.utils.gamelog import read_log

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVERS = ["examples.run_collisions", "examples.run_sim",
           "examples.bounce_kick_demo", "examples.run_dmpc_sim",
           "examples.run_centralized_sim", "examples.visualize_game",
           "examples.mc_example_1", "examples.mc_example_2",
           "examples.matchups", "examples.bench_sweep", "examples.bench_mpc",
           "examples.mc_scaling", "examples.train_es", "tools.dist_equiv",
           "tools.bench_grind", "tools.bench_sol", "tools.reconcile_bias",
           "graft_entry"]


@pytest.fixture(autouse=True, scope="module")
def _inference_mode():
    """Nothing here is differentiated: the module's torch work runs in
    inference mode, without autograd's per-operation bookkeeping."""
    with torch.inference_mode():
        yield


def _main(name, argv):
    return importlib.import_module(f"robogame_tpu_torch.{name}").main(argv)


def test_run_collisions_matches_jax_scripted_rollout(tmp_path):
    sched = run_collisions.demo_schedule()[:100]
    for i, n in enumerate(("A1", "A2", "B1", "B2")):
        np.savetxt(tmp_path / f"{n}.txt", sched[:, i])
    log = str(tmp_path / "coll.log")
    assert run_collisions.main(["--dir", str(tmp_path), "--f64", "--log",
                                log, "--cpu"]) == 0
    got = read_log(log)
    assert got.shape == (100, 29)
    jp = JParams(dt=0.05, winning_score=100, dtype="float64")
    s0 = j_initial_state(jp, x0_puck=[-1.0, 0.0, 0.0, 0.0])
    _, recs = jax.jit(lambda s, u: j_rollout(s, u, jp))(s0, jnp.asarray(
        sched))
    np.testing.assert_array_equal(got[:, 1:3], np.asarray(recs.score))
    np.testing.assert_allclose(
        got[:, 3:13], np.asarray(recs.positions).reshape(100, 10),
        rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", ["mc_example_1", "mc_example_2"])
def test_mc_example_writes_the_jax_configuration(name, tmp_path, capsys):
    out = str(tmp_path / "mc")
    assert _main(f"examples.{name}", ["--runs", "2", "--T", "0.5", "--out",
                                      out, "--cpu"]) == 0
    assert "aggregate:" in capsys.readouterr().out
    ref = str(tmp_path / "jax")
    write_configuration(JParams(dt=0.05, winning_score=4, engine="sweep"),
                        JMcParams(num_runs=2, T=0.5, log_prefix=ref,
                                  x0_ball=(-1.0, 0.0, 0.0, 0.0)))
    with open(os.path.join(out, "configuration.txt")) as f, open(
            os.path.join(ref, "configuration.txt")) as g:
        assert f.read() == g.read()
    for i in (1, 2):
        assert read_log(os.path.join(out, f"mc_run_{i}.log")).shape == (
            10, 29)


def _jax_matchups():
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        return importlib.import_module("matchups")
    finally:
        sys.path.pop(0)


def test_matchups_records_and_invariants(tmp_path, monkeypatch, capsys):
    path = str(tmp_path / "m.json")
    assert matchups.main(["--runs", "2", "--T", "0.05", "--no-check",
                          "--json", path, "--cpu"]) == 0
    with open(path) as f:
        recs = json.load(f)
    assert list(recs) == [m[0] for m in matchups.MATCHUPS]

    # JAX's run_matchup on given scores and damage: its monte_carlo and
    # policy stubbed, so nothing compiles
    jm = _jax_matchups()
    rng = np.random.default_rng(3)
    scores = rng.integers(0, 5, (16, 2)).astype(np.int32)
    damage = rng.exponential(2.0, (16, 4, 4))
    monkeypatch.setattr(jm, "make_policy", lambda *a: (None, lambda: None))
    monkeypatch.setattr(jm, "monte_carlo", lambda *a, **k: SimpleNamespace(
        scores=scores, damage=damage))
    monkeypatch.setattr(jm, "time", SimpleNamespace(
        time=iter([0.0, 1.0]).__next__))
    args = SimpleNamespace(runs=16, T=20.0, chunk=100)
    want = jm.run_matchup("classical_cbf", "classical", "classical", True,
                          args, JParams(), None, None, None)
    got = matchups.record("classical_cbf", scores, damage, 20.0, 1.0, 400)
    assert list(got) == list(want) == list(recs["classical_cbf"])
    timing = ("wall_s", "games_per_s", "steps_per_s")
    assert {k: v for k, v in got.items() if k not in timing} == {
        k: v for k, v in want.items() if k not in timing}
    capsys.readouterr()

    # the invariants, kept and broken one at a time
    base = {m[0]: dict(goals_a=1.0, goals_b=0.5, damage_mean=2.0)
            for m in matchups.MATCHUPS}
    base["classical_cbf"]["damage_mean"] = 1.0
    base["dmpc_vs_cmpc_cbf"]["damage_mean"] = 1.0
    assert matchups.invariant_failures(base) == []
    for m, key, val, name in (
            ("classical_cbf", "damage_mean", 3.0, "CBF damage"),
            ("dmpc_vs_cmpc_cbf", "damage_mean", 3.0, "CBF damage (mpc)"),
            ("dmpc_vs_noop", "goals_a", 0.0, "dmpc scores")):
        broken = json.loads(json.dumps(base))
        broken[m][key] = val
        assert matchups.invariant_failures(broken) == [name]
    broken = json.loads(json.dumps(base))
    broken["classical_nocbf"].update(goals_a=0.0, goals_b=0.0)
    assert matchups.invariant_failures(broken) == ["classical scores"]


def test_single_game_drivers_write_their_logs(tmp_path):
    # the MPC games on a 2-point final-time grid (their --t-grid)
    for name, steps, extra in (("run_sim", 2, []),
                               ("run_dmpc_sim", 1, ["--t-grid", "2"]),
                               ("run_centralized_sim", 1, ["--t-grid", "2"])):
        log = str(tmp_path / f"{name}.log")
        assert _main(f"examples.{name}", ["--steps", str(steps), "--log",
                                          log, *extra, "--cpu"]) == 0
        got = read_log(log)
        assert got.shape == (steps, 29) and np.isfinite(got).all()
    gif = str(tmp_path / "sim.gif")
    assert _main("examples.visualize_game", [str(tmp_path / "run_sim.log"),
                                             "--save", gif, "--no-show",
                                             "--cpu"]) == 0
    assert os.path.getsize(gif) > 0


def test_bounce_kick_demo_scores_in_f32(tmp_path):
    log = str(tmp_path / "bounce.log")
    assert bounce_kick_demo.main(["--wall", "up", "--log", log,
                                  "--cpu"]) == 0
    got = read_log(log)
    assert got[-1, 1] == 1 and got[-1, 2] == 0
    assert got[:, 4].max() > 1.5          # the puck neared the upper wall


def test_benches_run_on_the_cpu(monkeypatch, capsys):
    # bench_sweep's rows at 8 games x 2 steps in place of its sizes
    monkeypatch.setattr(bench_sweep, "SIZES", (8,))
    monkeypatch.setattr(bench_sweep, "N_STEPS", 2)
    monkeypatch.setattr(bench_sweep, "NOISE_B", 8)
    assert bench_sweep.main(["--cpu"]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]
    assert [(r["engine"], r["noise"]) for r in rows] == [
        ("pallas_exact", 0.0), ("pallas", 0.0), ("pallas", 1.0),
        ("pallas_exact", 1.0)]
    assert all(list(r) == ["B", "engine", "noise", "steps_per_sec",
                           "vs_ref"] and r["steps_per_sec"] > 0
               for r in rows)
    small = ["--t-grid", "2", "--sqp-iters", "1", "--qp-iters", "20"]
    for argv, head in ((["--batch", "2"], "2 DMPC solves"),
                       (["--mode", "closed-loop", "--batch", "2", "--steps",
                         "1"], "closed-loop dmpc"),
                       (["--mode", "latency", "--steps", "1"],
                        "latency dmpc")):
        assert bench_mpc.main([*argv, *small, "--cpu"]) == 0
        assert capsys.readouterr().out.startswith(head)


def test_mc_scaling_and_dryrun_in_one_gloo_process(capsys):
    assert mc_scaling.main(["--cpu", "--games-per-device", "4", "--steps",
                            "3"]) == 0
    out = capsys.readouterr().out
    assert "devices=  1" in out and "scaling_eff=1.00" in out
    assert graft_entry.main(["--nproc", "1", "--cpu"]) == 0
    assert "entry ok: (256, 5, 4)" in capsys.readouterr().out


@pytest.mark.slow
def test_two_and_four_gloo_processes(capsys):
    """The dry run at two and four processes, and the sweep over 1, 2 and
    4 (each process starts an interpreter: about 6 s here)."""
    graft_entry.dryrun_multichip(2, device="cpu")
    graft_entry.dryrun_multichip(4, device="cpu")
    assert mc_scaling.main(["--virtual", "4", "--games-per-device", "8",
                            "--steps", "5"]) == 0
    out = capsys.readouterr().out
    assert all(f"devices={n:3d}" in out for n in (1, 2, 4))


def test_drivers_exit_non_zero_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in DRIVERS:
        with pytest.raises(SystemExit) as e:
            _main(name, [])
        assert e.value.code not in (0, None), name
        assert "--cpu" in str(e.value.code), name
