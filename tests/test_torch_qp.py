"""The port's linear models and its batched QP solve against the JAX
package's, on the same inputs made with numpy.

* ``models/lqsys`` against JAX in f64: the same closed forms and powers,
  so agreement is to f64 roundoff (1e-12).
* K2's plain route (``solve_qp_lanes`` on CPU tensors, which runs
  ``ops/qp.py::solve_qp``) against JAX's ``solve_qp_lanes`` in interpret
  mode at the small shapes of tests/test_qp_pallas.py, with that file's
  tolerance (atol 2e-3, rtol 1e-2, flags agreeing on >= 8 of 9): the same
  ADMM in f32, with sums taken in another order, and equality rows at
  1e3 rho make K ill-conditioned enough to amplify that roundoff.
* At the classical skills' shape (n=30, m=60) and DMPC's (40, 140, row
  scaling) against JAX's ``solve_qp_batch`` (its vmapped ``solve_qp``);
  the port's ``solve_qp_batch`` against it within tests/test_ops.py's
  atol 1e-4.
* The ``ops`` and ``physics`` packages export JAX's names.
* Shared operands: a grouped call equals the broadcast call bitwise.
* K2's grouped algebra (``solve_qp_grouped_plain``: one f64 factorization
  per shared operand, then the factor-free ADMM in f32) at the skills'
  shape against JAX's vmapped ``solve_qp`` and the port's in f64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogame_tpu.models import lqsys as jlq
from robogame_tpu.ops.qp import solve_qp_batch as j_solve_qp_batch
from robogame_tpu.ops.qp_pallas import solve_qp_lanes as j_solve_qp_lanes

import robogame_tpu_torch as rt
from robogame_tpu_torch.control import trajopt as tt
from robogame_tpu_torch.models import lqsys as tlq
from robogame_tpu_torch.ops import qp, qp_lanes
from robogame_tpu_torch.ops.qp_lanes import solve_qp_lanes
from _port_env import port_module  # noqa: F401  (autouse fixture)


def make_qps(B, n, m, seed=0, n_eq=0, cond=10.0):
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(B, n, n)).astype(np.float32)
    H = np.einsum("bij,bkj->bik", Q, Q) / n + \
        np.eye(n, dtype=np.float32) / cond
    g = rng.normal(size=(B, n)).astype(np.float32)
    A = rng.normal(size=(B, m, n)).astype(np.float32)
    l = rng.uniform(-2.0, 0.0, size=(B, m)).astype(np.float32)
    u = rng.uniform(0.1, 2.0, size=(B, m)).astype(np.float32)
    if n_eq:
        b_eq = rng.uniform(-0.5, 0.5, size=(B, n_eq)).astype(np.float32)
        l[:, :n_eq] = b_eq
        u[:, :n_eq] = b_eq
    return H, g, A, l, u


@functools.lru_cache(maxsize=None)
def _jax_solver(kw):
    """JAX's solve_qp_batch (solve_qp vmapped over problems), one jitted
    program per set of keyword arguments (one compile instead of one per
    eager op)."""
    return jax.jit(lambda *a: j_solve_qp_batch(*a, **dict(kw)))


def _jax_vmapped(qp, **kw):
    return _jax_solver(tuple(sorted(kw.items())))(
        *(jnp.asarray(a) for a in qp))


def _port(qp, **kw):
    return solve_qp_lanes(*(torch.from_numpy(a) for a in qp), **kw)


# ---------------------------------------------------------------------------
# models/lqsys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["euler_ab", "exact_ab", "exact_puck_ab"])
def test_discretizations_match_jax_f64(fn):
    for h in (0.05, 0.3125, 0.0033):
        j = getattr(jlq, fn)(h, 0.5, dtype=jnp.float64)
        t = getattr(tlq, fn)(h, 0.5, dtype=torch.float64)
        for a, b in zip(j if isinstance(j, tuple) else (j,),
                        t if isinstance(t, tuple) else (t,)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-15)


@pytest.mark.parametrize("N", [1, 15, 20])
def test_prediction_matrices_and_condense_match_jax_f64(N):
    A, B = jlq.exact_ab(0.1, 0.5, dtype=jnp.float64)
    At, Bt = tlq.exact_ab(0.1, 0.5, dtype=torch.float64)
    jp, jg = jlq.prediction_matrices(A, B, N)
    tp, tg = tlq.prediction_matrices(At, Bt, N)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-12)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-12)
    jf, jgf = jlq.condense(A, B, N)
    tf, tgf = tlq.condense(At, Bt, N)
    assert tf.shape == (4 * N, 4) and tgf.shape == (4 * N, 2 * N)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-12)
    np.testing.assert_allclose(tgf.numpy(), np.asarray(jgf), atol=1e-12)


# ---------------------------------------------------------------------------
# K2's plain route against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,n_eq,n_seg", [(8, 12, 0, 4), (8, 20, 4, 4),
                                            (10, 17, 0, 2)])
def test_plain_route_matches_jax_lanes_interpret(n, m, n_eq, n_seg):
    """n_seg=2 at n=10 also covers a non-default segment count (and halves
    the interpret-mode kernel, whose segments are unrolled)."""
    qp = make_qps(9, n, m, seed=n + m, n_eq=n_eq)
    ref = j_solve_qp_lanes(*(jnp.asarray(a) for a in qp), iters=60,
                           n_seg=n_seg)
    got = _port(qp, iters=60, n_seg=n_seg)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x),
                               atol=2e-3, rtol=1e-2)
    agree = np.mean(got.converged.numpy() == np.asarray(ref.converged))
    assert agree >= 8 / 9
    assert got.prim_res.shape == got.dual_res.shape == (9,)


def test_skills_shape_matches_jax_solve_qp():
    """Random QPs and the classical skills' own condensed QPs (16 final-time
    candidates of 4 reach problems) at n=30, m=60, 60 iterations."""
    rnd = make_qps(24, 30, 60, seed=7)
    rng = np.random.default_rng(11)
    x0 = torch.from_numpy(np.concatenate(
        [rng.uniform(-3, 3, (4, 2)), rng.uniform(-2, 2, (4, 2))],
        1).astype(np.float32))
    xf = torch.from_numpy(np.concatenate(
        [rng.uniform(-3, 3, (4, 2)), rng.uniform(-2, 2, (4, 2))],
        1).astype(np.float32))
    grid, _, g, lo, hi = tt.candidate_qps(x0, xf, rt.SimParams())
    skills = (grid.H.repeat_interleave(4, 0).numpy(), g.numpy(),
              grid.A.repeat_interleave(4, 0).numpy(), lo.numpy(), hi.numpy())
    for qp in (rnd, skills):
        ref = _jax_vmapped(qp, iters=60)
        got = _port(qp, iters=60)
        np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x),
                                   atol=2e-3, rtol=1e-2)
        np.testing.assert_array_equal(got.converged.numpy(),
                                      np.asarray(ref.converged))
        np.testing.assert_allclose(got.prim_res.numpy(),
                                   np.asarray(ref.prim_res), rtol=1e-2,
                                   atol=1e-5)
    assert got.converged.numpy().mean() > 0.5


def _skills_qps(seed=11):
    """The classical skills' own condensed QPs: 16 final-time candidates of
    4 reach problems (n=30, m=60); candidate k of problem b is problem
    4 k + b and shares grid.H[k], grid.A[k]."""
    rng = np.random.default_rng(seed)
    x0, xf = (torch.from_numpy(np.concatenate(
        [rng.uniform(-3, 3, (4, 2)), rng.uniform(-2, 2, (4, 2))],
        1).astype(np.float32)) for _ in range(2))
    grid, _, g, lo, hi = tt.candidate_qps(x0, xf, rt.SimParams())
    return grid.H, g, grid.A, lo, hi


@pytest.mark.parametrize("ref", ["jax", "f64"])
def test_grouped_plain_matches_jax_solve_qp_and_f64(ref):
    """The grouped algebra on the skills' QPs at 60 iterations, against
    JAX's vmapped f32 ``solve_qp`` ("jax") and against the port's
    ``solve_qp`` in f64 ("f64"): flags equal and x within
    test_skills_shape_matches_jax_solve_qp's tolerance (atol 2e-3, rtol
    1e-2): another factorization of the same K, so the iterates part by
    f32 roundoff only."""
    H, g, A, lo, hi = _skills_qps()
    got = qp_lanes.solve_qp_grouped_plain(H, g, A, lo, hi, group=4,
                                          iters=60)
    Hb, Ab = H.repeat_interleave(4, 0), A.repeat_interleave(4, 0)
    if ref == "jax":
        want = _jax_vmapped((Hb.numpy(), g.numpy(), Ab.numpy(), lo.numpy(),
                             hi.numpy()), iters=60)
        x, conv = np.asarray(want.x), np.asarray(want.converged)
    else:
        want = qp.solve_qp(*(t.double() for t in (Hb, g, Ab, lo, hi)),
                           iters=60)
        x, conv = want.x.numpy(), want.converged.numpy()
    np.testing.assert_allclose(got.x.numpy(), x, atol=2e-3, rtol=1e-2)
    np.testing.assert_array_equal(got.converged.numpy(), conv)
    assert got.converged.numpy().mean() > 0.5


def test_dmpc_shape_with_row_scaling_matches_jax_solve_qp():
    qp = make_qps(8, 40, 140, seed=3)
    ref = _jax_vmapped(qp, iters=60, scale_rows=True)
    got = _port(qp, iters=60, scale_rows=True)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x),
                               atol=5e-3, rtol=5e-2)


def test_solve_qp_batch_matches_jax():
    """The port's solve_qp_batch against JAX's on the 8 random DMPC-shaped
    QPs above (the same JAX program), within tests/test_ops.py:37-40's
    atol 1e-4: the same ADMM in f32 (measured 1.1e-6); flags equal."""
    qp = make_qps(8, 40, 140, seed=3)
    ref = _jax_vmapped(qp, iters=60, scale_rows=True)
    got = rt.ops.solve_qp_batch(*(torch.from_numpy(a) for a in qp),
                                iters=60, scale_rows=True)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))


def test_exports_match_jax():
    """``ops`` exports JAX's names; ``physics`` exports JAX's, with
    ``step_batch`` for ``step_pallas_batch``, and the sorted rollout."""
    import robogame_tpu.ops as j_ops
    import robogame_tpu.physics as j_physics
    import robogame_tpu_torch.ops as t_ops
    import robogame_tpu_torch.physics as t_physics
    assert set(t_ops.__all__) == set(j_ops.__all__)
    want = (set(j_physics.__all__) - {"step_pallas_batch"}) | {
        "step_batch", "rollout_pallas_sorted"}
    assert want <= set(t_physics.__all__)
    for mod in (t_ops, t_physics):
        assert all(callable(getattr(mod, name)) for name in mod.__all__)


@pytest.mark.parametrize("scale_rows", [False, True])
def test_grouped_operands_equal_broadcast_bitwise(scale_rows):
    """Problem p reads H and A at p // group; the result is the broadcast
    call's to the bit (the same solve on the same numbers)."""
    G, group, n, m = 3, 5, 30, 60
    H, _, A, _, _ = (torch.from_numpy(a) for a in make_qps(G, n, m, 1))
    _, g, _, l, u = (torch.from_numpy(a) for a in
                     make_qps(G * group, n, m, 2))
    a = solve_qp_lanes(H, g, A, l, u, iters=40, group=group,
                       scale_rows=scale_rows)
    b = solve_qp_lanes(H.repeat_interleave(group, 0), g,
                       A.repeat_interleave(group, 0), l, u, iters=40,
                       scale_rows=scale_rows)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_solve_qp_lanes_checks_shapes():
    H, g, A, l, u = (torch.from_numpy(a) for a in make_qps(6, 4, 5))
    with pytest.raises(ValueError, match="groups of 4"):
        solve_qp_lanes(H[:1], g, A[:1], l, u, group=4)
    with pytest.raises(ValueError):
        solve_qp_lanes(H, g, A, l[:, :3], u)
    with pytest.raises(ValueError, match="cuda or cpu"):
        solve_qp_lanes(*(t.to("meta") for t in (H, g, A, l, u)))
    sol = solve_qp_lanes(H[:3], g, A[:3], l, u, group=2, iters=20)
    assert sol.x.shape == (6, 4) and sol.converged.dtype == torch.bool
