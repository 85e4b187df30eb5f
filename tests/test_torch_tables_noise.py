"""The port's sub-step tables and noise model against the JAX package:
the numpy tables bitwise, the noise transforms on the same standard
normals, and the re-propagation noise covariance against L L^T w^2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogame_tpu.config import SimParams as JParams
from robogame_tpu.physics import pallas_step as jps
from robogame_tpu.physics import sweep as jsw

from robogame_tpu_torch.config import SimParams
from robogame_tpu_torch.physics import exact_step as tex
from robogame_tpu_torch.physics.noise import REPROPAGATION, game_normals
from robogame_tpu_torch.physics import sweep as tsw
from _port_env import port_module  # noqa: F401  (autouse fixture)

CONFIGS = [dict(), dict(dt=0.02, grid_points=20, tau_player=0.3,
                        tau_puck=1.0)]


@pytest.mark.parametrize("kw", CONFIGS)
def test_tables_bitwise_equal_jax(kw):
    jp, tp = JParams(**kw), SimParams(**kw)
    for a, b in zip(jsw._substep_affine_np(jp), tsw._substep_affine_np(tp)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jsw._affine_tables_np(jp), tsw._affine_tables_np(tp)):
        np.testing.assert_array_equal(a, b)
    assert tex._table_key(tp) == jps._table_key(jp)
    for a, b in zip(jps._tables(jps._table_key(jp)),
                    tex._tables(tex._table_key(tp))):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert jps._substep_scalars(jp) == tex._substep_scalars(tp)


def test_sparse_populate_table_holds_every_nonzero():
    """K1 populates from the 6 non-zeros per row of M; M has no others."""
    p = SimParams()
    M, _, _ = tex._tables(tex._table_key(p))
    M6 = tex._sparse_M(p)
    rebuilt = np.zeros_like(M)
    for c in range(20):
        rebuilt[c][:, tex._NZ[c]] = M6[c]
    np.testing.assert_array_equal(rebuilt, M)


@pytest.mark.parametrize("noise", [0.7, 1.0])
def test_noise_transforms_match_jax_on_same_xi(noise):
    """Same standard normals (JAX's own draw from the key) through JAX's
    populate_noise / repropagation_noise and the port's transforms.
    Tolerance 1e-6 relative to the largest value: f32 einsums summed in
    another order."""
    jp = JParams(dtype="float32", stochastic=True, noise=noise)
    tp = SimParams(dtype="float32", stochastic=True, noise=noise)
    G = jp.grid_points

    @jax.jit
    def jax_side(key):
        """JAX's draws and transforms for one key, one compile for all."""
        return (jax.random.normal(key, (G, 4, 4), jnp.float32),
                jsw.populate_noise(key, jp),
                jax.random.normal(key, (G + 1, 4, 4), jnp.float32),
                jsw.repropagation_noise(key, jp, n=G + 1))

    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    for key in keys:
        xi_p, ref_p, xi_r, ref_r = (np.array(a) for a in jax_side(key))
        xi, ref = xi_p, ref_p
        got = tsw.populate_noise(torch.from_numpy(xi)[None], tp)[0].numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())
        xi, ref = xi_r, ref_r
        got = tsw.repropagation_noise(torch.from_numpy(xi)[None],
                                      tp)[0].numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())


def test_noise_planes_layout_matches_jax():
    """The (B, G, 4, 4) contributions land in the same plane rows and
    columns as JAX's _noise_plane/_rnoise_plane: rebuild JAX's planes from
    the contributions JAX draws and compare bitwise."""
    B = 3
    jp = JParams(dtype="float32", stochastic=True, noise=1.0)
    G = jp.grid_points

    @jax.jit
    def jax_side():
        """JAX's contributions and planes as one jitted program."""
        states = jax.vmap(lambda k: jps.GameState(
            x=jnp.zeros((5, 4), jnp.float32), score=jnp.zeros(2, jnp.int32),
            damage=jnp.zeros((4, 4), jnp.float32),
            t=jnp.zeros((), jnp.float32), key=k))(
                jax.random.split(jax.random.PRNGKey(9), B))
        keys = jax.vmap(jax.random.split)(states.key)
        pop = jnp.stack([jsw.populate_noise(keys[b, 1], jp)
                         for b in range(B)])
        k2 = jax.vmap(lambda k: jax.random.fold_in(k, 7))(keys[:, 1])
        rep = jnp.stack([jsw.repropagation_noise(k2[b], jp, n=G + 1)
                         for b in range(B)])
        return (pop, rep, jps._noise_plane(states, jp),
                jps._rnoise_plane(states, jp))

    pop, rep, npl, rpl = (np.array(a) for a in jax_side())
    np.testing.assert_array_equal(
        tex._noise_plane(torch.from_numpy(pop)).numpy(), npl[:, :, :B])
    np.testing.assert_array_equal(
        tex._rnoise_plane(torch.from_numpy(rep)).numpy(), rpl[:, :, :B])


def test_repropagation_noise_covariance_is_LLt_w2():
    """Sample covariance of the per-substep contributions drawn through
    the port's stream (substream 1 of 16384 games' Philox streams, the
    re-propagation draw) equals w^2 L L^T (16384 x 4 players x 51 rows of
    samples: relative sampling error ~1%; tolerance 5% of the largest
    entry)."""
    w = 0.8
    p = SimParams(dtype="float32", stochastic=True, noise=w)
    B = 16384
    keys = torch.stack([torch.arange(B), torch.ones(B, dtype=torch.int64)],
                       dim=1)
    xi = game_normals(keys, (p.grid_points + 1) * 16, REPROPAGATION).view(
        B, p.grid_points + 1, 4, 4)
    eta = tsw.repropagation_noise(xi, p).reshape(-1, 4).double().numpy()
    _, _, L = tsw._substep_affine_np(p)
    ref = w * w * (L @ L.T)
    cov = np.cov(eta.T)
    np.testing.assert_allclose(cov, ref, rtol=0, atol=0.05 * np.abs(ref).max())


def test_stochastic_step_keys_and_noise_depend_on_the_game_only():
    """A game's noise comes from its own (seed, counter): the same game in
    two batches gets the same planes, and the counter advances."""
    import robogame_tpu_torch as rt
    p = SimParams(engine="pallas_exact", stochastic=True, noise=1.0)
    s1 = rt.initial_state(p, seed=[5, 6, 7], device="cpu")
    s2 = rt.initial_state(p, seed=[9, 6], device="cpu")
    n1, r1, k1 = tex._noise_planes(s1, p)
    n2, r2, k2 = tex._noise_planes(s2, p)
    torch.testing.assert_close(n1[..., 1], n2[..., 1], rtol=0, atol=0)
    torch.testing.assert_close(r1[..., 1], r2[..., 1], rtol=0, atol=0)
    assert not torch.equal(n1[..., 0], n1[..., 1])
    np.testing.assert_array_equal(k1.numpy(), [[5, 1], [6, 1], [7, 1]])
