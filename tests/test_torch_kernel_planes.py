"""K1's plain PyTorch version against the JAX kernel at the plane level:
the same lane-major input planes through the port's ``_kernel_call`` and
JAX's (interpret mode), in the stochastic mode with JAX's own noise planes,
and in the two-phase modes exact_export / exact_resume, whose exported grid
and 48-row carry the port reads back unchanged.

Tolerances are those of the grinding test in tests/test_pallas_exact.py
(x 5e-3, damage 2e-3) where the event loop runs deep, 1e-4 where it ran
one event; scores exact."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogame_tpu.config import SimParams as JParams
from robogame_tpu.physics import pallas_step as jps
from robogame_tpu.state import initial_state as j_initial_state

import robogame_tpu_torch as rt
from robogame_tpu_torch.physics import exact_step as tex

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _inference_mode():
    """Nothing here is differentiated: the module's torch work runs in
    inference mode, without autograd's per-operation bookkeeping."""
    with torch.inference_mode():
        yield

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from dist_equiv import make_sched, make_states  # noqa: E402

B = 16


def _t(a):
    """A JAX plane, without its lane padding, as a torch tensor."""
    return torch.from_numpy(np.array(a)[..., :B])


def _close(port, ref, xtol, dtol):
    (xt, mt, dt), (xj, mj, dj) = port, ref
    np.testing.assert_array_equal(mt[0:3].numpy(), np.asarray(mj)[0:3, :B])
    assert np.abs(xt.numpy() - np.asarray(xj)[:, :B]).max() < xtol
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj)[:, :B],
                               rtol=dtol, atol=dtol)


def _pressed_states(params):
    """Player A1 pressed into the right wall and A2 driven into it: wall
    and pair events within the step."""
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B, dtype=jnp.uint32))
    st = jax.vmap(lambda k: j_initial_state(params, seed=k))(keys)
    half = params.arena_x / 2
    x = st.x.at[:, 0, :].set(jnp.asarray([half - 0.202, 0.0, 3.0, 0.5],
                                         jnp.float32))
    x = x.at[:, 1, :].set(jnp.asarray([half - 0.7, 0.05, 4.0, 0.0],
                                      jnp.float32))
    u = np.tile(np.asarray([[8., 0.], [8., 0.], [0., 0.], [0., 0.]],
                           np.float32)[None], (B, 1, 1))
    return st._replace(x=x), u


def test_stochastic_exact_with_jax_noise_planes():
    jp = JParams(dtype="float32", engine="pallas_exact", stochastic=True,
                 noise=1.0, two_phase=False)
    tp = rt.SimParams(dtype="float32", engine="pallas_exact",
                      stochastic=True, noise=1.0, two_phase=False)

    @jax.jit
    def jax_side():
        """The JAX planes and kernel call as one jitted program (one
        compile instead of one per eager op)."""
        states, u = _pressed_states(jp)
        planes, _ = jps._to_planes(states, jp)
        uj = jps._u_plane(jnp.asarray(u), B)
        npl = jps._noise_plane(states, jp)
        rpl = jps._rnoise_plane(states, jp)
        return planes, uj, npl, rpl, jps._kernel_call(
            planes, uj, jp, npl, mode="exact", rnoise_plane=rpl)

    planes, uj, npl, rpl, ref = jax_side()
    port = tex._kernel_call(tuple(_t(p) for p in planes), _t(uj), tp,
                            _t(npl), mode="exact", rnoise_plane=_t(rpl))
    _close(port, ref, 5e-3, 2e-3)
    assert float(np.asarray(ref[2])[:, :B].sum()) > 0     # pair damage
    assert (np.asarray(ref[1])[3, :B] >= 3).all()          # event chains


def test_export_then_resume_match_jax():
    """Corner pile-ups (pre-ground by the port).  Phase 1 (cap 1) exports
    the same grid and slot carry as JAX; resuming from JAX's exported
    grid and carry gives JAX's resume result."""
    jp = JParams(dtype="float32", engine="pallas_exact")
    tp = rt.SimParams(dtype="float32", engine="pallas_exact")
    js = make_states(B, None, JParams(dtype="float32", engine="event"))
    us = make_sched("corner", B, 30, seed=3)
    s = tex.GameState(*(torch.from_numpy(np.array(a)) for a in
                        (js.x, js.score, js.damage, js.t)),
                      key=torch.zeros((B, 2), dtype=torch.int64))
    for k in range(29):
        s = rt.step_batch(s, torch.from_numpy(us[k]), tp, device="cpu")
    pt = tex._to_planes(s)
    ut = tex._u_plane(torch.from_numpy(us[29]), B)
    pad = lambda a: jnp.asarray(np.pad(a.numpy(), ((0, 0), (0, 128 - B))))
    pj = tuple(pad(a) for a in pt)
    uj = pad(ut)

    ref1, gj, cj = jps._kernel_call(pj, uj, jp, mode="exact_export", cap=1)
    out1, gt, ct = tex._kernel_call(pt, ut, tp, mode="exact_export", cap=1)
    _close(out1, ref1, 1e-4, 1e-4)
    assert np.abs(gt.numpy() - np.asarray(gj)[..., :B]).max() < 1e-4
    cjn = np.asarray(cj)[:, :B]
    ctn = ct.numpy()
    np.testing.assert_array_equal(ctn[5:23], cjn[5:23])    # slots, goals
    np.testing.assert_array_equal(ctn[39:], cjn[39:])      # events, pad
    np.testing.assert_allclose(ctn[0:5], cjn[0:5], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ctn[23:39], cjn[23:39], rtol=0, atol=1e-6)
    assert (cjn[15:20].sum(axis=0) > 0).sum() > B // 2         # pending

    ref2 = jps._kernel_call(pj, uj, jp, mode="exact_resume", cap=48,
                            grid_in=gj, carry_in=cj)
    out2 = tex._kernel_call(pt, ut, tp, mode="exact_resume", cap=48,
                            grid_in=_t(gj), carry_in=_t(cj))
    _close(out2, ref2, 5e-3, 2e-3)
    np.testing.assert_array_equal(out2[1][3].numpy(),
                                  np.asarray(ref2[1])[3, :B])  # events
