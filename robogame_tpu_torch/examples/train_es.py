"""Train an attacker policy with evolution strategies on the batched sim.

    python -m robogame_tpu_torch.examples.train_es [--gens 30] [--pop 512]
        [--steps 100] [--sigma 0.05] [--lr 0.03] [--engine sweep|pallas]
        [--cpu]

Every candidate policy of a generation plays its own game, and the whole
population steps as one batch through ``physics/step.py::step_batch``
(antithetic sampling: half the perturbations drawn, the other half their
negatives).  ``--engine pallas`` runs the parallel-resolution kernel K6,
two-phase, one host fetch of the pending count a step; ``--engine sweep``
runs the sweep engine (plain PyTorch).

Task: a 2-layer tanh policy (8 -> 32 -> 2) drives player A2 to score
against a static defense (the other three players command zero) within
``--steps`` control steps.  Reward: 0.02 vx_puck - 0.01 |p_A2 - p_puck|
summed over the steps, plus 10 per goal of team A.  ES needs no gradient:
the policy is batched tensor products over the candidates, with TF32 off.

The initial parameters are numpy's ``default_rng(0).normal(0, 0.1)``, as
in the JAX example, so both start from the same policy.  The puck starts
and the perturbations come from a ``torch.Generator`` seeded 0 on the
run's device: JAX's threefry streams cannot be reproduced, so a run's
trajectory is the port's own.  :func:`theta_from_numpy` carries a flat
parameter vector in JAX's layout (``W1`` (8, 32) row-major, ``b1``, ``W2``
(32, 2), ``b2``) into a batch of candidates, so a JAX policy plays the
same here.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..config import A2, PUCK, SimParams
from ..physics.step import step_batch
from ..state import initial_state
from . import add_cpu_flag, driver_device, host

PROG = "python -m robogame_tpu_torch.examples.train_es"
OBS_DIM = 8          # own state (4) + puck state (4)
HID = 32
ACT_DIM = 2


def n_params() -> int:
    return OBS_DIM * HID + HID + HID * ACT_DIM + ACT_DIM


def theta_from_numpy(theta, pop: int | None = None,
                     device="cuda") -> torch.Tensor:
    """Flat parameters in JAX's layout, (P,) or (pop, P), as a (pop, P)
    f32 tensor on ``device``; a (P,) vector is repeated ``pop`` times
    (once by default)."""
    t = torch.as_tensor(np.asarray(theta), dtype=torch.float32)
    if t.shape[-1] != n_params() or t.ndim > 2:
        raise ValueError(f"expected (..., {n_params()}) parameters, got "
                         f"{tuple(t.shape)}")
    if t.ndim == 1:
        t = t[None].expand(pop or 1, -1)
    return t.contiguous().to(device)


def policy_apply(theta: torch.Tensor, obs: torch.Tensor,
                 input_limit: float) -> torch.Tensor:
    """theta (pop, P), obs (pop, OBS_DIM) -> (pop, 2) velocity commands,
    candidate i's policy on observation i."""
    pop = theta.shape[0]
    i = OBS_DIM * HID
    W1 = theta[:, :i].reshape(pop, OBS_DIM, HID)
    b1 = theta[:, i:i + HID]
    i += HID
    W2 = theta[:, i:i + HID * ACT_DIM].reshape(pop, HID, ACT_DIM)
    b2 = theta[:, i + HID * ACT_DIM:]
    h = torch.tanh(torch.bmm(obs[:, None], W1)[:, 0] + b1)
    return input_limit * torch.tanh(torch.bmm(h[:, None], W2)[:, 0] + b2)


def puck_starts(pop: int, generator: torch.Generator,
                device) -> torch.Tensor:
    """(pop, 4) puck starts: position U(-1, 1)^2 x (2, 1.5), velocity 0."""
    k0 = torch.rand((pop, 2), generator=generator, device=device) * 2 - 1
    x0 = torch.zeros((pop, 4), device=device)
    x0[:, :2] = k0 * torch.tensor([2.0, 1.5], device=device)
    return x0


def make_eval(params: SimParams, n_steps: int, pop: int, device="cuda"):
    """``evaluate(thetas, x0_puck=None, generator=None)``: thetas (pop, P)
    -> (rewards (pop,), goals of team A (pop,)).  The puck starts are
    ``x0_puck`` (pop, 4) when given, else drawn from ``generator``."""
    dev = torch.device(device)
    seeds = list(range(pop))

    def evaluate(thetas, x0_puck=None, generator=None):
        if x0_puck is None:
            x0_puck = puck_starts(pop, generator, dev)
        s = initial_state(params, x0_puck=x0_puck.cpu(), seed=seeds,
                          device=dev)
        rs = []
        for _ in range(n_steps):
            obs = torch.cat([s.x[:, A2, :], s.x[:, PUCK, :]], dim=-1)
            u = torch.zeros((pop, 4, 2), dtype=torch.float32, device=dev)
            u[:, A2] = policy_apply(thetas, obs, params.input_limit)
            s = step_batch(s, u, params, device=dev)
            # shaping: puck velocity toward the goal, proximity to the puck
            vx = s.x[:, PUCK, 2]
            dist = torch.linalg.vector_norm(
                s.x[:, A2, 0:2] - s.x[:, PUCK, 0:2], dim=-1)
            rs.append(0.02 * vx - 0.01 * dist)
        goals = s.score[:, 0]
        return torch.stack(rs).sum(0) + 10.0 * goals.float(), goals

    return evaluate


def es_update(theta, eps, rewards, sigma: float, lr: float):
    """One ES step: rewards normalised by the population's mean and std
    (ddof 0, JAX's ``std``), the estimate (r eps).mean / sigma."""
    r = (rewards - rewards.mean()) / (rewards.std(correction=0) + 1e-8)
    grad = (r[:, None] * eps).mean(0) / sigma
    return theta + lr * grad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[1])
    ap.add_argument("--gens", type=int, default=30)
    ap.add_argument("--pop", type=int, default=512)   # must be even
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--sigma", type=float, default=0.05)
    ap.add_argument("--lr", type=float, default=0.03)
    ap.add_argument("--engine", default="sweep", choices=["sweep", "pallas"])
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    if args.pop % 2:
        ap.error("--pop must be even (antithetic pairs)")
    dev = driver_device(args, PROG)
    torch.backends.cuda.matmul.allow_tf32 = False

    params = SimParams(dt=0.05, winning_score=100, engine=args.engine,
                       dtype="float32")
    P = n_params()
    evaluate = make_eval(params, args.steps, args.pop, dev)
    theta = theta_from_numpy(np.random.default_rng(0).normal(0, 0.1, (P,)),
                             device=dev)[0]
    gen = torch.Generator(device=dev).manual_seed(0)

    t0 = time.time()
    for g in range(args.gens):
        eps = torch.randn((args.pop // 2, P), generator=gen, device=dev)
        eps = torch.cat([eps, -eps])                  # antithetic
        cand = theta[None] + args.sigma * eps
        rewards, goals = evaluate(cand, generator=gen)
        theta = es_update(theta, eps, rewards, args.sigma, args.lr)
        if g % 5 == 0 or g == args.gens - 1:
            print(f"gen {g:3d}  reward {float(rewards.mean()):7.3f} "
                  f"(best {float(rewards.max()):7.3f})  "
                  f"goals/ep {float(goals.float().mean()):.3f}  "
                  f"[{time.time() - t0:.0f}s]", flush=True)

    # final greedy evaluation: the trained parameters on every game
    rewards, goals = evaluate(theta_from_numpy(host(theta), args.pop, dev),
                              generator=gen)
    print(f"trained policy: mean reward {float(rewards.mean()):.3f}, "
          f"goals/episode {float(goals.float().mean()):.3f} over {args.pop} "
          "games", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
