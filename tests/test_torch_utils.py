"""The port's checkpoint, profiling and visualization utilities against
the JAX package's (tests/test_utils.py, tests/test_visualize.py).

* A checkpoint of a nest (a game state, a dict with a list, a Python int)
  comes back equal, on the target's device and dtype; a nest of another
  leaf count is refused.
* ``checkpointed_scan`` stopped after 4 steps and resumed to 10 equals an
  uninterrupted run bitwise, and JAX's ``checkpointed_scan`` of the sweep
  engine in f64 from the same start within 1e-12.
* ``PhaseTimer`` and ``counters_line`` give what JAX's give; ``trace``
  writes a TensorBoard trace on the CPU.
* ``load_mc_results`` and ``interpret_mc_results`` read the same logs as
  JAX's do; one GIF renders through ``animate_mc_run`` (matplotlib
  tests skip where it is missing).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogame_tpu.config import SimParams as JParams
from robogame_tpu.physics.engine import step as jstep
from robogame_tpu.state import initial_state as j_initial_state
from robogame_tpu.utils import checkpoint as jck
from robogame_tpu.utils import profiling as jprof

import robogame_tpu_torch as rt
from robogame_tpu_torch.physics.step import unbatch
from robogame_tpu_torch.utils import (PhaseTimer, checkpointed_scan,
                                      counters_line, load_checkpoint,
                                      save_checkpoint, trace)
from robogame_tpu_torch.utils.gamelog import GameLogWriter, rows_from_states

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _inference_mode():
    """Nothing here is differentiated: the module's torch work runs in
    inference mode, without autograd's per-operation bookkeeping."""
    with torch.inference_mode():
        yield


PARAMS = rt.SimParams(dtype="float64", engine="sweep")
X0_PUCK = [0.0, 0.3, 2.0, 1.0]


def test_checkpoint_roundtrip(tmp_path):
    s = rt.initial_state(PARAMS, x0_puck=[1.0, 0.5, -2.0, 0.3], seed=[7, 8],
                         device="cpu")
    tree = {"state": s, "carry": [torch.arange(3), (True, 5)]}
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, tree, meta={"step": 42})
    like = {"state": rt.initial_state(rt.SimParams(dtype="float32"),
                                      x0_puck=torch.zeros(2, 4),
                                      device="cpu"),
            "carry": [torch.zeros(3, dtype=torch.int32), (False, 0)]}
    got, meta = load_checkpoint(p, like)
    assert meta == {"step": 42}
    assert isinstance(got["state"], rt.GameState)
    assert got["state"].x.dtype == torch.float32
    assert got["carry"][0].dtype == torch.int32
    assert got["carry"][1] == (True, 5)
    assert torch.equal(got["state"].x, s.x.float())
    assert torch.equal(got["state"].key, s.key)
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(p, {"state": s})


def test_checkpointed_scan_resumes_and_matches_jax(tmp_path):
    u = torch.zeros(4, 2, dtype=torch.float64)

    def step_fn(s):
        return rt.step(s, u, PARAMS, device="cpu")

    s0 = unbatch(rt.initial_state(PARAMS, x0_puck=X0_PUCK, device="cpu"))
    full = checkpointed_scan(step_fn, s0, 10, str(tmp_path / "full.npz"),
                             every=100)
    p = str(tmp_path / "run.npz")
    checkpointed_scan(step_fn, s0, 4, p, every=2)       # stopped at 4
    assert load_checkpoint(p, s0)[1] == {"step": 4}
    resumed = checkpointed_scan(step_fn, s0, 10, p, every=3)
    assert load_checkpoint(p, s0)[1] == {"step": 10}
    for a, b in zip(full, resumed):
        assert torch.equal(a, b)
    jp = JParams(dtype="float64", engine="sweep")
    ju = jnp.zeros((4, 2))
    jfull = jck.checkpointed_scan(
        lambda s: jstep(s, ju, jp), j_initial_state(jp, x0_puck=X0_PUCK), 10,
        str(tmp_path / "jax.npz"), every=100)
    np.testing.assert_allclose(resumed.x.numpy(), np.asarray(jfull.x),
                               atol=1e-12)
    assert float(resumed.t) == float(jfull.t)


def test_phase_timer_counters_and_trace(tmp_path):
    for pt in (PhaseTimer(), jprof.PhaseTimer()):
        with pt.phase("work", items=100):
            sum(range(1000))
        with pt.phase("idle"):
            pass
        assert set(pt.seconds()) == {"work", "idle"}
        assert pt.seconds()["work"] > 0 and pt.rates()["work"] > 0
        assert pt.report().startswith("idle: ")
    for args in (("m", 1.234, "x/s", 2.0), ("steps", 3791829.44, "1/s"),
                 ("r", -0.05, "s", 1.005)):
        assert json.loads(counters_line(*args)) == json.loads(
            jprof.counters_line(*args))
    with trace(str(tmp_path / "tr")) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(d) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(d, files[0])) as f:
        assert "aten::mm" in f.read()


def _write_fake_log(path, n=40):
    t = np.arange(n) * 0.05
    scores = np.zeros((n, 2))
    scores[n // 2:, 0] = 1
    pos = np.zeros((n, 5, 2))
    pos[:, 0, 0] = np.linspace(-4, 4, n)        # puck crosses the arena
    pos[:, 1:, 0] = np.linspace(-2, 2, n)[:, None]
    dmg = np.zeros((n, 4, 4))
    dmg[n // 2:, 0, 2] = 0.7
    with GameLogWriter(path, native=False) as w:
        w.write_rows(rows_from_states(t, scores, pos, dmg))


def _mc_dir(tmp_path, runs):
    d = tmp_path / "mc"
    d.mkdir()
    (d / "configuration.txt").write_text(
        "\n".join(str(v) for v in
                  [runs, 2.0, 0.05, 3, 0, 0, 0, 0, 0, 0.1, 0.5, 1.0, 0.5]))
    for i in range(1, runs + 1):
        _write_fake_log(str(d / f"mc_run_{i}.log"), n=30 + 5 * i)
    return str(d)


def test_mc_results_against_jax(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    from robogame_tpu.utils import visualize as jvis
    from robogame_tpu_torch.utils import visualize as tvis

    d = _mc_dir(tmp_path, 2)
    got = tvis.load_mc_results(d)
    want = jvis.load_mc_results(d)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    cfg, scores, dmg = tvis.interpret_mc_results(
        d, save=str(tmp_path / "h.png"), show=False)
    assert cfg["num_runs"] == 2 and scores.shape == (2, 2)
    assert dmg.shape == (2, 16) and (tmp_path / "h.png").exists()


def test_animate_mc_run_renders_gif(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    from robogame_tpu_torch.utils.visualize import animate_mc_run

    d = _mc_dir(tmp_path, 1)
    out = str(tmp_path / "run1.gif")
    assert animate_mc_run(d, 1, fps=5, save=out, show=False) == out
    assert np.fromfile(out, dtype=np.uint8).size > 1000
