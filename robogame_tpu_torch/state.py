"""Game state of batch-leading tensors, and conversions.

* ``x``      -- (B, 5, 4) entity states, rows [A1, A2, B1, B2, PUCK], cols
               [px, py, vx, vy]
* ``score``  -- (B, 2) int32 [teamA, teamB]
* ``damage`` -- (B, 4, 4) pairwise accumulated damage
* ``t``      -- (B,) sim time
* ``key``    -- (B, 2) int64 per-game random stream: [seed, counter].  A
               stochastic step of a game draws its noise from Philox4x32-10
               keyed by the seed's two 32-bit words, at counter words
               (block, counter + 1, substream, iteration) with the
               substreams of ``physics/noise.py`` (0 the populate, 1 K1's
               re-propagation, 2 and 3 the event engine's populate and
               loop iterations), and advances the counter, so a game's
               noise depends on its own key, never on the batch.

The JAX package keys its games with threefry keys, which torch cannot
reproduce; :func:`from_numpy` / :func:`to_numpy` carry a JAX state's arrays
across so both sides can step the same games.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import (A1, A2, B1, B2, PUCK, VEC_A1, VEC_A2, VEC_B1, VEC_B2,
                     VEC_PK, SimParams, resolve_device)


class GameState(NamedTuple):
    x: torch.Tensor        # (B, 5, 4)
    score: torch.Tensor    # (B, 2) int32
    damage: torch.Tensor   # (B, 4, 4)
    t: torch.Tensor        # (B,)
    key: torch.Tensor      # (B, 2) int64 [seed, counter]


def _keys(seeds, B: int, device) -> torch.Tensor:
    seeds = torch.as_tensor(seeds, dtype=torch.int64).reshape(-1)
    if seeds.numel() == 1 and B > 1:
        seeds = seeds.expand(B)
    if seeds.numel() != B:
        raise ValueError(f"expected {B} seeds, got {seeds.numel()}")
    return torch.stack([seeds, torch.zeros_like(seeds)], dim=1).to(device)


def initial_state(params: SimParams, x0_puck=None, seed=0,
                  device="cuda") -> GameState:
    """Reset state.  Players start at (+-X/4, +-Y/4); the puck state is an
    argument (zeros by default).  ``x0_puck`` is (4,) or (B, 4) and
    ``seed`` an int or B ints; the batch size follows from them."""
    dev = resolve_device(device)
    dt = params.torch_dtype
    B = 1
    if x0_puck is not None:
        x0_puck = torch.as_tensor(x0_puck, dtype=dt)
        if x0_puck.ndim == 2:
            B = x0_puck.shape[0]
    if not isinstance(seed, int):
        B = max(B, len(seed))
    qx, qy = params.arena_x / 4.0, params.arena_y / 4.0
    x = torch.tensor([[-qx, qy, 0.0, 0.0],
                      [-qx, -qy, 0.0, 0.0],
                      [qx, qy, 0.0, 0.0],
                      [qx, -qy, 0.0, 0.0],
                      [0.0, 0.0, 0.0, 0.0]], dtype=dt).repeat(B, 1, 1)
    if x0_puck is not None:
        x[:, PUCK] = x0_puck
    return GameState(
        x=x.to(dev),
        score=torch.zeros((B, 2), dtype=torch.int32, device=dev),
        damage=torch.zeros((B, 4, 4), dtype=dt, device=dev),
        t=torch.zeros((B,), dtype=dt, device=dev),
        key=_keys(seed, B, dev),
    )


def undecided(state: GameState, params: SimParams) -> torch.Tensor:
    """(B,) True while neither team has reached winning_score."""
    return torch.all(state.score < params.winning_score, dim=1)


def to_vector(state: GameState) -> torch.Tensor:
    """(B, 22) flat vectors in the reference layout
    [scoreA, scoreB, puck, A1, A2, B1, B2]."""
    x = state.x
    return torch.cat([state.score.to(x.dtype), x[:, PUCK], x[:, A1],
                      x[:, A2], x[:, B1], x[:, B2]], dim=1)


def _entities(vec: torch.Tensor) -> torch.Tensor:
    return torch.stack([vec[..., VEC_A1:VEC_A1 + 4],
                        vec[..., VEC_A2:VEC_A2 + 4],
                        vec[..., VEC_B1:VEC_B1 + 4],
                        vec[..., VEC_B2:VEC_B2 + 4],
                        vec[..., VEC_PK:VEC_PK + 4]], dim=-2)


def from_vector(vec, params: SimParams, t=0.0, seed=0,
                device="cuda") -> GameState:
    """Inverse of :func:`to_vector` for (22,) or (B, 22) vectors (damage is
    not represented in the vector and starts at zero)."""
    dev = resolve_device(device)
    dt = params.torch_dtype
    vec = torch.as_tensor(vec, dtype=dt).reshape(-1, 22).to(dev)
    B = vec.shape[0]
    return GameState(
        x=_entities(vec),
        score=vec[:, :2].to(torch.int32),
        damage=torch.zeros((B, 4, 4), dtype=dt, device=dev),
        t=torch.full((B,), float(t), dtype=dt, device=dev),
        key=_keys(seed, B, dev),
    )


def from_numpy(x, score, damage, t, seeds=None, device="cuda",
               dtype: torch.dtype = torch.float32) -> GameState:
    """A batch of games from numpy arrays -- x (B,5,4), score (B,2),
    damage (B,4,4), t (B,) -- e.g. a JAX ``GameState``'s leaves.  ``seeds``
    (B ints, default 0..B-1) start the games' random streams."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.array(x), dtype=dtype)
    B = x.shape[0]
    seeds = np.arange(B) if seeds is None else seeds
    return GameState(
        x=x.reshape(B, 5, 4).to(dev),
        score=torch.as_tensor(np.array(score)).to(torch.int32).reshape(
            B, 2).to(dev),
        damage=torch.as_tensor(np.array(damage), dtype=dtype).reshape(
            B, 4, 4).to(dev),
        t=torch.as_tensor(np.array(t), dtype=dtype).reshape(B).to(dev),
        key=_keys(seeds, B, dev),
    )


def to_numpy(state: GameState) -> GameState:
    """The same state with numpy leaves (host copies)."""
    return GameState(*(a.detach().cpu().numpy() for a in state))


class SimStateView:
    """Read-only accessor over one game of a :class:`GameState` (``game``
    picks it) or over a flat 22-vector."""

    _PLAYER_ROW = {("A", 1): A1, ("A", 2): A2, ("B", 1): B1, ("B", 2): B2}

    def __init__(self, state, game: int = 0):
        if isinstance(state, GameState):
            self._x = state.x[game]
            self._score = state.score[game]
        else:
            vec = torch.as_tensor(state)
            self._x = _entities(vec)
            self._score = vec[:2]

    def get_player_state(self, team: str, player_id: int):
        return self._x[self._PLAYER_ROW[(team, player_id)]]

    def get_player_pos(self, team: str, player_id: int):
        return self.get_player_state(team, player_id)[0:2]

    def get_player_vel(self, team: str, player_id: int):
        return self.get_player_state(team, player_id)[2:4]

    def get_puck_state(self):
        return self._x[PUCK]

    def get_puck_pos(self):
        return self._x[PUCK][0:2]

    def get_puck_vel(self):
        return self._x[PUCK][2:4]

    @property
    def scores(self):
        return self._score

    @property
    def entity_array(self):
        """(5, 4) entity states in row order [A1, A2, B1, B2, PUCK]."""
        return self._x
