"""The port's K1 tools (``robogame_tpu_torch.tools.bench_grind``,
``bench_sol`` and ``reconcile_bias``) on the CPU, and what they rest on.

* K1's plain version (what ``_kernel_call`` runs on CPU tensors) at event
  caps 2 and 9 against JAX's jitted event ``step`` at
  ``collision_counter_lim`` 3 and 10, one step at a time from the corner
  grinders' states that JAX's event engine evolved (8 games x 40 steps of
  ``make_sched("corner", seed=3)``), within tests/test_pallas_exact.py's
  tolerances (x 5e-3, damage 2e-3 + 2e-3 |damage|), scores equal; some
  game reaches each cap (9: in 8 of the 320 game-steps);
* ``fit_slope`` equals ``np.linalg.lstsq`` on a synthetic line;
* ``bench_grind`` (K1 one- and two-phase, K6) and ``bench_sol`` (two caps)
  print their rows at 8 games x 4 steps;
* ``reconcile_bias`` runs its four phases at 16 games x 10 steps and
  writes the three records;
* ``load_final`` reads a dump of JAX's ``dump_final``, and JAX's reads the
  port's.

Two JAX jit compiles: the event engine's rollout at each cap.
"""

import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from robogame_tpu.config import SimParams as JParams
from robogame_tpu.physics.engine import step as j_step

import robogame_tpu_torch as rt
from robogame_tpu_torch.physics import exact_step as ex
from robogame_tpu_torch.tools import bench_grind, bench_sol, reconcile_bias
from robogame_tpu_torch.tools import dist_equiv as de

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import dist_equiv as jde  # noqa: E402

torch.set_num_threads(1)

B, STEPS = 8, 40


@pytest.fixture(autouse=True, scope="module")
def _inference_mode():
    """Nothing here is differentiated: the module's torch work runs in
    inference mode, without autograd's per-operation bookkeeping."""
    with torch.inference_mode():
        yield


@pytest.mark.parametrize("cap", [2, 9])
def test_k1_plain_matches_jax_event_step_at_the_cap(cap):
    jp = JParams(dtype="float32", engine="event",
                 collision_counter_lim=cap + 1)
    sched = jde.make_sched("corner", B, STEPS, seed=3)

    @jax.jit
    def evolve(u):
        s0 = jde.make_states(B, None, jp)

        def body(s, uk):
            s2 = jax.vmap(lambda st, uu: j_step(st, uu, jp))(s, uk)
            return s2, s2
        return s0, lax.scan(body, s0, u)[1]

    s0, ss = evolve(jnp.asarray(sched))
    seq = [np.concatenate([np.asarray(a)[None], np.asarray(b)])
           for a, b in zip((s0.x, s0.score, s0.damage, s0.t),
                           (ss.x, ss.score, ss.damage, ss.t))]
    x, score, damage, t = seq
    tp = rt.SimParams(dtype="float32", engine="pallas_exact",
                      two_phase=False, collision_counter_lim=cap + 1)
    at_cap = 0
    for k in range(STEPS):
        s = rt.from_numpy(x[k], score[k], damage[k], t[k], device="cpu")
        xo, meta, dmg = ex._kernel_call(
            ex._to_planes(s), ex._u_plane(torch.as_tensor(sched[k]), B), tp,
            mode="exact")
        np.testing.assert_array_equal(meta[0:2].T.numpy(), score[k + 1])
        dx = np.abs(xo.T.reshape(B, 5, 4).numpy() - x[k + 1]).max()
        assert dx < 5e-3, (k, dx)
        np.testing.assert_allclose(dmg.T.reshape(B, 4, 4).numpy(),
                                   damage[k + 1], rtol=2e-3, atol=2e-3)
        at_cap += int((meta[3] >= cap).sum())
    assert at_cap > 0, f"no game reached cap {cap}"


def test_fit_slope_equals_lstsq():
    caps = np.array(bench_sol.CAPS, float)
    ts = 3e-4 + 2.5e-6 * caps + np.array([1e-6, -2e-6, 0.5e-6, 1e-6])
    want = np.linalg.lstsq(np.vstack([caps, np.ones(4)]).T, ts,
                           rcond=None)[0]
    assert bench_sol.fit_slope(bench_sol.CAPS, ts) == tuple(want)
    assert bench_sol.fit_slope([1, 2, 3], [5.0, 7.0, 9.0]) == pytest.approx(
        (2.0, 3.0))


def test_bench_grind_and_bench_sol_print_their_rows(monkeypatch, capsys):
    tiny = ["--batch", "8", "--steps", "4", "--cpu"]
    num = r"[\d,]+"
    for extra, engine, two in (([], "pallas_exact", False),
                               (["--two-phase"], "pallas_exact", True),
                               (["--engine", "pallas"], "pallas", False)):
        assert bench_grind.main([*tiny, "--reps", "2", *extra]) == 0
        rows = capsys.readouterr().out.splitlines()
        assert [r.split()[0] for r in rows] == ["corner", "uniform"]
        for r in rows:
            assert re.match(
                rf"\w+ +{engine} two_phase={two} B=8 steps/s best={num} "
                rf"all=\['{num}', '{num}'\] dmg_ck=\d+\.\d{{3}}", r), r
            assert ("cap_steps=" in r) == (engine == "pallas_exact"), r
    monkeypatch.setattr(bench_sol, "CAPS", (2, 9))
    monkeypatch.setattr(bench_sol, "REPS", 1)
    monkeypatch.setattr(bench_sol, "KERNEL_REPS", 1)
    assert bench_sol.main(tiny) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "# B=8 steps=4 on cpu"
    for x in out[1:3]:
        assert re.match(r"cap= +\d+  step= +\d+\.\d{3} ms .* kernel=\d+\.\d{4}"
                        r" ms  game-steps at the cap \d\.\d{3}$", x), x
    for x, what in zip(out[3:5], ("slope: ", "kernel slope: ")):
        assert x.startswith(what) and "ns/game-iteration" in x, x
    assert re.match(r"uniform two-phase: step=\d+\.\d{3} ms .*export "
                    r"\d+\.\d{4} ms \+ resume \d+\.\d{4} ms", out[5]), out[5]


def test_reconcile_bias_phases(tmp_path, capsys):
    base = ["--games", "16", "--steps", "10", "--cache",
            str(tmp_path / "r")]
    for phase in (["cpu"], ["gpu", "--cpu"]):
        assert reconcile_bias.main(["--phase", *phase, *base]) == 0
    assert sorted(os.listdir(tmp_path)) == [
        "r_event_cpu.npz", "r_event_gpu.npz", "r_exact_gpu.npz"]
    # a phase whose dump exists is skipped
    assert reconcile_bias.main(["--phase", "cpu", *base]) == 0
    assert "# cached:" in capsys.readouterr().out
    path = str(tmp_path / "c.json")
    assert reconcile_bias.main(["--phase", "compare", *base, "--json",
                                path]) == 0
    with open(path) as f:
        recs = json.load(f)["records"]
    assert [r["label"] for r in recs] == [
        "corner: event_cpu-vs-event_gpu (platform only)",
        "corner: exact_gpu-vs-event_gpu (same platform)",
        "corner: exact_gpu-vs-event_cpu (campaign mode)"]
    assert all(r["games"] == 16 and np.isfinite(r["damage_z"])
               for r in recs)
    # both event rollouts ran on this CPU: the same arrays
    assert recs[0]["score_match_rate"] == 1.0 and recs[0][
        "ks_player_x"] == 0.0
    path = str(tmp_path / "p.json")
    assert reconcile_bias.main(["--phase", "perturb", *base, "--cpu",
                                "--json", path]) == 0
    with open(path) as f:
        recs = json.load(f)["records"]
    assert [r["label"] for r in recs] == [
        "corner 10step: event_cpu-vs-event_cpu+1ulp"]
    capsys.readouterr()


def test_load_final_reads_jax_dumps(tmp_path):
    rng = np.random.default_rng(6)
    f = jde._Final(rng.normal(size=(5, 5, 4)).astype(np.float32),
                   rng.integers(0, 3, (5, 2)).astype(np.int32),
                   rng.exponential(1.0, (5, 4, 4)).astype(np.float32))
    jde.dump_final(str(tmp_path / "j.npz"), f)
    got = de.load_final(str(tmp_path / "j.npz"))
    de.dump_final(str(tmp_path / "t.npz"), got)
    back = jde.load_final(str(tmp_path / "t.npz"))
    for a in ("x", "score", "damage"):
        np.testing.assert_array_equal(getattr(got, a), getattr(f, a))
        np.testing.assert_array_equal(getattr(back, a), getattr(f, a))
        assert getattr(back, a).dtype == getattr(f, a).dtype
