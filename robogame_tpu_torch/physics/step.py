"""The batched control step, dispatched on ``SimParams.engine``.

* ``"pallas_exact"``: the event-order-exact step, K1
  (:mod:`.exact_step`, ``csrc/exact_step.cu``);
* ``"pallas"``: the parallel-resolution step, K6
  (:mod:`.parallel_step`, ``csrc/parallel_step.cu``);
* ``"sweep"``: the sweep engine (:func:`.sweep.step_sweep`), plain
  PyTorch in the params' dtype;
* ``"event"``: not ported yet.

The kernel engines run one- or two-phase (``SimParams.two_phase``); on CPU
tensors their plain PyTorch versions run instead of the kernels.
"""

from __future__ import annotations

import torch

from ..config import SimParams, resolve_device
from ..state import GameState
from . import exact_step as ex
from . import parallel_step as ps
from .sweep import game_draws, populate_noise, step_sweep


def _check_device(t: torch.Tensor, dev: torch.device, what: str):
    if t.device.type != dev.type or (dev.index is not None
                                     and t.device.index != dev.index):
        raise ValueError(f"{what} lie on {t.device}, the step was asked to "
                         f"run on {dev}")


def step_batch(states: GameState, controls: torch.Tensor,
               params: SimParams, device="cuda") -> GameState:
    """One batched control step: states are batch-leading, controls
    (B, 4, 2).  Runs on ``device`` (cuda unless the caller asks for the
    CPU); the states and controls must lie there.  Decided games (a score
    at winning_score) keep their state.  Stochastic steps draw each game's
    noise from its own key and advance it."""
    dev = resolve_device(device)
    if params.engine == "event":
        raise NotImplementedError(
            "engine 'event' is not ported yet; the port's step runs "
            "'pallas_exact', 'pallas' and 'sweep'")
    _check_device(states.x, dev, "states")
    _check_device(controls, dev, "controls")
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
            (xp,), new_keys = game_draws(states, (params.grid_points,))
            npl = ex._noise_plane(populate_noise(xp, params))
        if params.two_phase:
            out = ps._twophase_planes(planes, u, params, npl)
        else:
            out = ps._kernel_call(planes, u, params, npl, mode="full")
    return ex._from_planes(out, states, new_keys, params)
