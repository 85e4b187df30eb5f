"""The port's mesh of processes and its chunked sweeps, as the JAX
package's tests/test_monte_carlo.py and tests/test_distributed.py hold
JAX's.

* Two Gloo processes run ``robogame_tpu_torch.distributed_mc`` on 33 games (padded to 34, a schedule sliced with them): scores exact,
  damage within 1e-5 and positions within 1e-4 of the one-process sweep.
* A mesh of this process alone (Gloo) gives the mesh-less sweep bitwise,
  records included, at 16 games and at 5; the sharded sweep on
  ``engine="pallas"`` agrees with the mesh-less sweep engine (JAX's
  ``test_sharded_pallas_mc_matches_sweep``).
* ``chunk_steps=7`` (40 steps: five segments and a tail) with JAX's
  counting chase policy gives the unchunked sweep bitwise, records and
  the policy's count included (tests/test_monte_carlo.py's check of
  JAX's chunking).
"""

import importlib
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import robogame_tpu_torch as rt
from robogame_tpu_torch import distributed_mc
from robogame_tpu_torch.parallel import make_mesh
from _port_env import port_module  # noqa: F401  (autouse fixture)

# the parallel package exports a function of the module's name
tmc = importlib.import_module("robogame_tpu_torch.parallel.monte_carlo")


@pytest.fixture(scope="module")
def mesh():
    """A mesh of this process alone, its process group torn down after
    the module."""
    m = make_mesh(device="cpu")
    yield m
    dist.destroy_process_group()


def test_two_process_distributed_mc(monkeypatch, capsys):
    """This process is distributed_mc's parent (it spawns the two workers
    and runs the one-process reference)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = distributed_mc.main(["--nproc", "2", "--games", "33", "--steps",
                              "30", "--sweep-iters", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out[-4000:]
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["ok"] is True and rec["global_devices"] == 2
    assert rec["score_exact"] and rec["damage_close"] and rec["x_close"]
    assert rec["stats_close"]
    # the damage must not be zero for its comparison to mean anything
    assert rec["stats"]["damage_total"] > 1.0


@pytest.mark.parametrize("engine,games", [("pallas_exact", 16),
                                          ("pallas", 5)])
def test_one_process_mesh_equals_meshless(mesh, engine, games):
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("games",)
    p = rt.SimParams(engine=engine)
    mc = rt.McParams(num_runs=games, T=0.5, randomize_x0=True)
    r1, rec1 = rt.monte_carlo(p, mc, log=True, device="cpu")
    r2, rec2 = rt.monte_carlo(p, mc, mesh=mesh, log=True, device="cpu")
    assert r2.scores.shape == (games, 2)
    for a, b in zip((*r1, *rec1), (*r2, *rec2)):
        assert torch.equal(a, b)
    assert rt.aggregate(r2)["games"] == games


def test_sharded_pallas_matches_sweep_engine(mesh):
    mc = rt.McParams(num_runs=16, T=0.5, randomize_x0=True)
    sh = rt.monte_carlo(rt.SimParams(engine="pallas"), mc, mesh=mesh,
                        device="cpu")
    un = rt.monte_carlo(rt.SimParams(engine="sweep"), mc, device="cpu")
    assert torch.equal(sh.scores, un.scores)
    np.testing.assert_allclose(sh.damage.numpy(), un.damage.numpy(),
                               atol=1e-5)


def _chase(ps, states):
    puck = states.x[:, 4:5, 0:2]
    d = puck - states.x[:, :4, 0:2]
    return ps + 1, 5.0 * d / (torch.linalg.norm(d, dim=-1, keepdim=True)
                              + 1e-6)


def test_chunked_sweep_is_bitwise():
    p = rt.SimParams(dtype="float64")
    mc = rt.McParams(num_runs=4, T=2.0, x0_ball=(1.0, 0.3, 0.0, 0.0))
    zero = torch.zeros(4, dtype=torch.int32)
    fin1, rec1 = tmc.sweep(p, mc, _chase, zero, log=True, device="cpu")
    r1 = rt.McResult(fin1.score, fin1.damage, fin1.t)
    r2, rec2 = rt.monte_carlo(p, mc, _chase, zero, log=True, chunk_steps=7,
                              device="cpu")
    assert rec2.t.shape[0] == 40
    for a, b in zip((*r1, *rec1), (*r2, *rec2)):
        assert torch.equal(a, b)
    # the policy's count is carried across the segments
    s0 = tmc._initial_states(p, mc, device="cpu")
    s, count = tmc._run_batch_chunked(s0, p, 40, _chase, zero, "cpu", False,
                                      7)
    assert (count == 40).all()
    for a, b in zip(fin1, s):
        assert torch.equal(a, b)
