"""The batched control step, dispatched on ``SimParams.engine``.

* ``"pallas_exact"``: the event-order-exact step, K1
  (:mod:`.exact_step`, ``csrc/exact_step.cu``);
* ``"pallas"``: the parallel-resolution step, K6
  (:mod:`.parallel_step`, ``csrc/parallel_step.cu``);
* ``"sweep"``: the sweep engine (:func:`.sweep.step_sweep`), plain
  PyTorch in the params' dtype;
* ``"event"``: the event engine (:func:`.engine._update_sim`), plain
  PyTorch in the params' dtype, the reference's semantics.

The kernel engines run one- or two-phase (``SimParams.two_phase``); on CPU
tensors their plain PyTorch versions run instead of the kernels.  They can
also return each game's activity (meta row 3: the loop iterations in
which the game had a live event), which :func:`rollout_pallas_sorted`
sorts the batch by.
"""

from __future__ import annotations

import torch

from ..config import SimParams, resolve_device
from ..state import GameState, undecided
from . import exact_step as ex
from . import parallel_step as ps
from .engine import _update_sim
from .sweep import game_draws, populate_noise, step_sweep


def _check_device(t: torch.Tensor, dev: torch.device, what: str):
    if t.device.type != dev.type or (dev.index is not None
                                     and t.device.index != dev.index):
        raise ValueError(f"{what} lie on {t.device}, the step was asked to "
                         f"run on {dev}")


_KERNEL_ENGINES = ("pallas_exact", "pallas")


def step_batch(states: GameState, controls: torch.Tensor,
               params: SimParams, device="cuda", with_activity=False):
    """One batched control step: states are batch-leading, controls
    (B, 4, 2).  Runs on ``device`` (cuda unless the caller asks for the
    CPU); the states and controls must lie there.  Decided games (a score
    at winning_score) keep their state.  Stochastic steps draw each game's
    noise from its own key and advance it.

    With ``with_activity`` (kernel engines only) returns ``(new_states,
    activity)``: activity (B,) float32 on the step's device counts the
    loop iterations in which each game had a live event (meta row 3 of
    K1 and K6, one- and two-phase alike)."""
    dev = resolve_device(device)
    _check_device(states.x, dev, "states")
    _check_device(controls, dev, "controls")
    if with_activity and params.engine not in _KERNEL_ENGINES:
        raise ValueError(f"with_activity needs a kernel engine "
                         f"{_KERNEL_ENGINES}, not {params.engine!r}")
    if params.engine == "event":
        return step_event(states, controls, params)[0]
    if params.engine == "sweep":
        return step_sweep(states, controls, params)
    B = states.score.shape[0]
    planes = ex._to_planes(states)
    u = ex._u_plane(controls, B)
    new_keys = states.key
    if params.engine == "pallas_exact":
        npl = rpl = None
        if params.stochastic:
            npl, rpl, new_keys = ex._noise_planes(states, params)
        if params.two_phase:
            out = ex._twophase_planes_exact(planes, u, params, npl, rpl)
        else:
            out = ex._kernel_call(planes, u, params, npl, mode="exact",
                                  rnoise_plane=rpl)
    else:
        npl = None
        if params.stochastic:
            # substream 0, the sweep engine's populate draw
            (xp,), new_keys = game_draws(states, (params.grid_points,))
            npl = ex._noise_plane(populate_noise(xp, params))
        if params.two_phase:
            out = ps._twophase_planes(planes, u, params, npl)
        else:
            out = ps._kernel_call(planes, u, params, npl, mode="full")
    new = ex._from_planes(out, states, new_keys, params)
    return (new, out[1][3]) if with_activity else new


def rollout_pallas_sorted(states: GameState, u_seq: torch.Tensor,
                          params: SimParams, resort_every: int = 1,
                          device="cuda") -> GameState:
    """A multi-step rollout on a kernel engine with the batch kept ordered
    by a decayed per-game activity (``act = 0.5 act + activity``), so
    that games with long event loops share blocks of the kernel's launch
    and quiet blocks free their slots early.  Every ``resort_every``-th
    step (a remainder of the steps runs unsorted) the states (the keys
    included: a game's noise stream travels with it), their order and
    their activity are gathered by ``argsort(-act)``.  Sorting only
    permutes the games, so the result, returned in the original order,
    equals the step-by-step rollout's.  ``u_seq`` is (n_steps, B, 4, 2)
    on the step's device."""
    if params.engine not in _KERNEL_ENGINES:
        raise ValueError(f"rollout_pallas_sorted runs a kernel engine "
                         f"{_KERNEL_ENGINES}, not {params.engine!r}")
    if resort_every < 1:
        raise ValueError(f"resort_every must be >= 1, got {resort_every}")
    dev = resolve_device(device)
    _check_device(states.x, dev, "states")
    _check_device(u_seq, dev, "controls")
    B = states.score.shape[0]
    n = u_seq.shape[0]
    last = n // resort_every * resort_every
    s = states
    idx = torch.arange(B, device=dev)
    act = torch.zeros(B, dtype=torch.float32, device=dev)
    for k in range(n):
        s, a = step_batch(s, u_seq[k][idx], params, device=dev,
                          with_activity=True)
        act = 0.5 * act + a
        if k < last and (k + 1) % resort_every == 0:
            order = torch.argsort(-act, stable=True)
            s = GameState(*(f[order] for f in s))
            idx, act = idx[order], act[order]
    back = torch.argsort(idx)
    return GameState(*(f[back] for f in s))


def step_event(states: GameState, controls: torch.Tensor,
               params: SimParams):
    """One event-engine step of every game on the states' device, and each
    game's loop iterations (B,).  A decided game keeps its whole state,
    its key included."""
    new, iters = _update_sim(states, controls, params)
    keep = undecided(states, params)
    sel = lambda n, o: torch.where(keep.view(-1, *([1] * (n.ndim - 1))), n,
                                   o)
    return GameState(*(sel(n, o) for n, o in zip(new, states))), iters


def batch_of_one(state: GameState) -> GameState:
    """One unbatched game's state (x (5, 4), score (2,), damage (4, 4), t
    (), key (2,)) as a batch of one."""
    return GameState(*(a[None] for a in state))


def unbatch(state: GameState) -> GameState:
    """The first game of a batch, unbatched."""
    return GameState(*(a[0] for a in state))


def step(state: GameState, controls, params: SimParams,
         device="cuda") -> GameState:
    """One control step of one unbatched game, controls (4, 2); any
    engine, run as a batch of one on ``device``."""
    dev = resolve_device(device)
    u = torch.as_tensor(controls, dtype=params.torch_dtype,
                        device=dev).reshape(1, 4, 2)
    return unbatch(step_batch(batch_of_one(state), u, params, device=dev))
