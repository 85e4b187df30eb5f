"""The PyTorch port's configuration, state conversions and dynamics against
the JAX package, plus two guards: the port imports no JAX, and its entry
points do not fall back to the CPU without being asked."""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robogame_tpu.config as jcfg
from robogame_tpu.physics import dynamics as jdyn
from robogame_tpu.state import from_vector as j_from_vector
from robogame_tpu.state import initial_state as j_initial_state
from robogame_tpu.state import to_vector as j_to_vector

import robogame_tpu_torch as rt
import robogame_tpu_torch.config as tcfg
from robogame_tpu_torch.parallel import make_mesh
from robogame_tpu_torch.physics import dynamics as tdyn
from _port_env import port_module  # noqa: F401  (autouse fixture)

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_NAMES = sorted(s[:-5] for s in os.listdir(GOLDEN)
                      if s.endswith(".json"))


@pytest.mark.parametrize("name", ["SimParams", "MpcParams", "CbfParams",
                                  "StrategyParams"])
def test_params_fields_and_defaults_equal_jax(name):
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jcfg, name))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(tcfg, name))}
    assert jf == tf


def test_ids_and_vector_offsets_equal_jax():
    for n in ("A1", "A2", "B1", "B2", "PUCK", "N_ENTITIES", "N_PLAYERS",
              "WALL_UP", "WALL_DOWN", "WALL_RIGHT", "WALL_LEFT",
              "INTER_AGENT", "PX", "PY", "VX", "VY", "VEC_TAS", "VEC_TBS",
              "VEC_PK", "VEC_A1", "VEC_A2", "VEC_B1", "VEC_B2", "VEC_SIZE"):
        assert getattr(tcfg, n) == getattr(jcfg, n), n
    p = tcfg.SimParams(dtype="float64")
    q = jcfg.SimParams(dtype="float64")
    assert p.torch_dtype == torch.float64
    for prop in ("dt_col", "radii", "masses", "taus", "drags"):
        assert getattr(p, prop) == getattr(q, prop)
    with pytest.raises(ValueError):
        tcfg.SimParams(engine="nope")


@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_golden_final_vectors_round_trip(name):
    """The golden ``.log.final`` vectors (loaded as tests/test_parity.py
    loads them) through from_vector/to_vector, against JAX's."""
    final = np.fromfile(os.path.join(GOLDEN, f"{name}.log.final"),
                        dtype="<f8")
    p = rt.SimParams(dtype="float64")
    s = rt.from_vector(final, p, device="cpu")
    js = j_from_vector(jnp.asarray(final), jcfg.SimParams(dtype="float64"))
    np.testing.assert_array_equal(s.x[0].numpy(), np.asarray(js.x))
    np.testing.assert_array_equal(s.score[0].numpy(), np.asarray(js.score))
    np.testing.assert_array_equal(rt.to_vector(s)[0].numpy(),
                                  np.asarray(j_to_vector(js)))
    np.testing.assert_array_equal(rt.to_vector(s)[0].numpy(), final)
    view = rt.SimStateView(s)
    np.testing.assert_array_equal(view.get_puck_state().numpy(), final[2:6])
    np.testing.assert_array_equal(view.get_player_pos("B", 2).numpy(),
                                  final[18:20])


def test_from_numpy_to_numpy_round_trip_and_initial_state():
    rng = np.random.default_rng(0)
    B = 6
    x = rng.standard_normal((B, 5, 4)).astype(np.float32)
    score = rng.integers(0, 3, (B, 2)).astype(np.int32)
    dmg = rng.random((B, 4, 4)).astype(np.float32)
    t = rng.random(B).astype(np.float32)
    s = rt.from_numpy(x, score, dmg, t, seeds=range(10, 16), device="cpu")
    back = rt.to_numpy(s)
    for a, b in zip(back[:4], (x, score, dmg, t)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back.key[:, 0], np.arange(10, 16))
    np.testing.assert_array_equal(
        rt.undecided(s, rt.SimParams(winning_score=2)).numpy(),
        (score < 2).all(axis=1))
    p = rt.SimParams()
    s0 = rt.initial_state(p, x0_puck=[1.0, 2.0, 3.0, 4.0], device="cpu")
    js0 = j_initial_state(jcfg.SimParams(), x0_puck=[1.0, 2.0, 3.0, 4.0])
    np.testing.assert_array_equal(s0.x[0].numpy(), np.asarray(js0.x))
    np.testing.assert_array_equal(s0.score[0].numpy(), np.asarray(js0.score))


def test_dynamics_match_jax_f64():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 4))
    u = rng.standard_normal((3, 5, 2))
    noise = rng.standard_normal((4, 3, 5, 2))
    jp = jcfg.SimParams(dtype="float64")
    tp = rt.SimParams(dtype="float64")
    jtau, jdrag, jr, jm = jdyn.entity_consts(jp)
    ttau, tdrag, tr, tm = tdyn.entity_consts(tp, device="cpu")
    for a, b in zip((jtau, jdrag, jr, jm), (ttau, tdrag, tr, tm)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for nz in (None, noise):
        ref = jdyn.rk4_step(jnp.asarray(x), jnp.asarray(u), 0.013, jtau,
                            jdrag, None if nz is None else jnp.asarray(nz))
        got = tdyn.rk4_step(torch.from_numpy(x), torch.from_numpy(u), 0.013,
                            ttau, tdrag,
                            None if nz is None else torch.from_numpy(nz))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-14, atol=1e-14)
    xp = x[:, :4]
    np.testing.assert_allclose(
        tdyn.exact_player_step(torch.from_numpy(xp),
                               torch.from_numpy(u[:, :4]), 0.05, 0.5).numpy(),
        np.asarray(jdyn.exact_player_step(jnp.asarray(xp),
                                          jnp.asarray(u[:, :4]), 0.05, 0.5)),
        rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(
        tdyn.exact_puck_step(torch.from_numpy(x[:, 4]), 0.05, 0.1).numpy(),
        np.asarray(jdyn.exact_puck_step(jnp.asarray(x[:, 4]), 0.05, 0.1)),
        rtol=1e-14, atol=1e-14)
    g = torch.Generator().manual_seed(3)
    sn = tdyn.sample_stage_noise(g, (7, 5, 2), 0.5, torch.float64)
    assert sn.shape == (4, 7, 5, 2) and sn.dtype == torch.float64


def _port_sources():
    pkg = os.path.join(ROOT, "robogame_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(pkg):
        out += [os.path.join(d, f) for f in files
                if f.endswith((".py", ".cu"))]
    return out


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    bad = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+robogame_tpu\b"
                     r"(?!_torch)|from\s+robogame_tpu\b(?!_torch))",
                     re.MULTILINE)
    rel = re.compile(r"robogame_tpu\.(?!.*_torch)")
    for path in _port_sources():
        with open(path) as f:
            src = f.read()
        assert not bad.search(src), path
        imports = [ln for ln in src.splitlines()
                   if re.match(r"\s*(import|from)\s", ln)]
        assert not any(rel.search(ln) for ln in imports), path


def test_entry_points_raise_without_a_card():
    """Without a device argument the port runs on CUDA; on a machine
    without a card it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = rt.SimParams(engine="pallas_exact")
    s = rt.initial_state(p, device="cpu")
    u = torch.zeros((1, 4, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.step_batch(s, u, p)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.monte_carlo(p, rt.McParams(num_runs=2, T=0.1))
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.initial_state(p)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.step_batch(s, u, p.replace(engine="event"))
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.GameSim()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
