"""The decentralized-MPC team (the reference's DMPCPlayer / DMPCTeam),
batched over games.

Counterpart of the JAX package's ``agents/dmpc_team.py``.  Per control step
each team picks a play, gives its attacker and defender a target state
(the strategy shapes with v_hit = 4), and each player solves its own DMPC
against the other three players' current positions.
:func:`team_step_batch` flattens both players of B games into one
:func:`..control.dmpc.compute_control_batch` (one K3 launch for all
2 B x t_grid candidates).

Play selection compares ``field * puck_x`` against ``arena_x -
d_goalie_defense`` (7.5) and ``arena_x - d_goalie_offense`` (5.0).  Since
|puck_x| <= arena_x / 2 = 5, neither defense trigger is reachable and the
reference team always plays OFFENSE; the port keeps that quirk.

:func:`dmpc_matchup` pairs a DMPC team A with a DMPC or a no-op team B as
a ``monte_carlo`` policy, optionally behind the CBF filter; against a
CMPC team B it is the reference's dmpc_vs_cmpc pairing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import (A1, A2, B1, B2, PUCK, CbfParams, MpcParams, SimParams,
                      StrategyParams, resolve_device)
from ..control.cbf import safe_control_batch
from ..control.cmpc import initial_cmpc_state
from ..control.dmpc import (DmpcState, compute_control,
                            compute_control_batch, initial_dmpc_state)
from ..state import SimStateView
from .centralized import OFFENSE as CMPC_OFFENSE
from .centralized import team_step_batch as cmpc_team_step_batch

OFFENSE, DEFENSE = 0, 1
ATTACKER, DEFENDER = 1, 2


class DmpcTeamState(NamedTuple):
    attacker: DmpcState
    defender: DmpcState


def initial_team_state(mpc: MpcParams, dtype=torch.float32, device="cuda",
                       batch: tuple = ()) -> DmpcTeamState:
    return DmpcTeamState(
        attacker=initial_dmpc_state(mpc, dtype, device, batch),
        defender=initial_dmpc_state(mpc, dtype, device, batch))


def select_play(puck, field: int, params: SimParams,
                strat: StrategyParams):
    """The reference team's play thresholds for pucks (B, 4): always
    OFFENSE under the reference constants (see the module docstring)."""
    px, vx = puck[:, 0], puck[:, 2]
    d1 = params.arena_x - strat.d_goalie_defense
    d2 = params.arena_x - strat.d_goalie_offense
    defense = (field * px > d1) | ((field * px > d2) &
                                   (field * vx > strat.v_thresh))
    return torch.where(defense, DEFENSE, OFFENSE).to(torch.int32)


def player_target(play, role: int, puck_pos, field: int, params: SimParams,
                  strat: StrategyParams):
    """DMPCPlayer's target state (B, 4) for plays (B,) and puck positions
    (B, 2)."""
    dtype, dev = puck_pos.dtype, puck_pos.device
    B = puck_pos.shape[0]
    gx = torch.full((B,), -field * params.arena_x / 2.0, dtype=dtype,
                    device=dev)
    zero = torch.zeros_like(gx)
    goal = torch.stack([gx, zero], dim=1)
    home = torch.stack([-gx, zero], dim=1)
    d = goal - puck_pos
    n = torch.sqrt((d * d).sum(-1, keepdim=True))
    hit = strat.v_hit * d / torch.where(n > 0, n, torch.ones_like(n))
    x_hit = torch.cat([puck_pos, hit], dim=1)
    x_hit2 = torch.cat([puck_pos, 2.0 * hit], dim=1)
    def_pos = home + (puck_pos - home) / 2.0
    x_home = torch.cat([def_pos, torch.zeros_like(def_pos)], dim=1)
    offense = (play == OFFENSE)[:, None]
    if role == ATTACKER:
        return torch.where(offense, x_hit, x_hit2)
    home_side = (field * puck_pos[:, 0] > 0)[:, None]
    return torch.where(offense, torch.where(home_side, x_home, x_hit), x_home)


def _rows(field: int):
    """(attacker, defender, opponent 1, opponent 2) entity rows."""
    return (A1, A2, B1, B2) if field < 0 else (B1, B2, A1, A2)


def team_inputs(x, field: int, params: SimParams, strat: StrategyParams):
    """Per game of x (B, 5, 4): both players' states (B, 2, 4), targets
    (B, 2, 4) and obstacle sets, the other three players' positions
    (B, 2, 3, 2); [attacker, defender] on axis 1."""
    a_row, d_row, o1, o2 = _rows(field)
    puck = x[:, PUCK]
    play = select_play(puck, field, params, strat)
    tgt_a = player_target(play, ATTACKER, puck[:, 0:2], field, params, strat)
    tgt_d = player_target(play, DEFENDER, puck[:, 0:2], field, params, strat)
    pos = lambda r: x[:, r, 0:2]
    obs_a = torch.stack([pos(d_row), pos(o1), pos(o2)], dim=1)
    obs_d = torch.stack([pos(a_row), pos(o1), pos(o2)], dim=1)
    return (torch.stack([x[:, a_row], x[:, d_row]], dim=1),
            torch.stack([tgt_a, tgt_d], dim=1),
            torch.stack([obs_a, obs_d], dim=1))


def _flat_states(ts: DmpcTeamState) -> DmpcState:
    """(B, ...) attacker and defender leaves -> (2B, ...), 2b + agent."""
    return DmpcState(*(torch.stack([a, d], dim=1).flatten(0, 1)
                       for a, d in zip(ts.attacker, ts.defender)))


def team_step_batch(ts: DmpcTeamState, x, field: int, params: SimParams,
                    mpc: MpcParams, strat: StrategyParams,
                    route: str = "fused"):
    """One control step of B games' DMPC teams: ``ts`` with (B, ...) leaves,
    x (B, 5, 4), ``field`` -1 (team A) or +1 (team B).  Both players of
    every game go through one ``compute_control_batch``.  Returns
    (new state, (B, 2, 2) [attacker, defender] velocities)."""
    B = x.shape[0]
    x0s, tgts, obss = team_inputs(x, field, params, strat)
    new, us = compute_control_batch(
        _flat_states(ts), x0s.flatten(0, 1), tgts.flatten(0, 1),
        obss.flatten(0, 1), params, mpc, route)
    unflat = [a.reshape((B, 2) + a.shape[1:]) for a in new]
    ts2 = DmpcTeamState(attacker=DmpcState(*(a[:, 0] for a in unflat)),
                        defender=DmpcState(*(a[:, 1] for a in unflat)))
    return ts2, us.reshape(B, 2, 2)


def team_step(ts: DmpcTeamState, x, field: int, params: SimParams,
              mpc: MpcParams, strat: StrategyParams):
    """One game: ``ts`` with unbatched leaves, x (5, 4) on one device; each
    player solves with :func:`..control.dmpc.compute_control`.  Returns
    (new state, (2, 2) [attacker, defender])."""
    x0s, tgts, obss = team_inputs(x[None], field, params, strat)
    out = [compute_control(st, x0s[0, i], tgts[0, i], obss[0, i], params,
                           mpc) for i, st in enumerate(ts)]
    return (DmpcTeamState(attacker=out[0][0], defender=out[1][0]),
            torch.stack([out[0][1], out[1][1]]))


def dmpc_state_from_numpy(st, device="cuda"):
    """A DmpcState (or DmpcTeamState) of tensors from one with array leaves
    of the same structure, e.g. the JAX package's warm state pulled to
    numpy; U and h keep their dtype, valid becomes bool."""
    dev = resolve_device(device)
    if hasattr(st, "attacker"):
        return DmpcTeamState(attacker=dmpc_state_from_numpy(st.attacker, dev),
                             defender=dmpc_state_from_numpy(st.defender, dev))
    return DmpcState(U=torch.as_tensor(np.array(st.U)).to(dev),
                     valid=torch.as_tensor(np.array(st.valid)).to(
                         torch.bool).to(dev),
                     h=torch.as_tensor(np.array(st.h)).to(dev))


def dmpc_state_to_numpy(st):
    """The same DmpcState (or DmpcTeamState) with numpy leaves."""
    if hasattr(st, "attacker"):
        return DmpcTeamState(attacker=dmpc_state_to_numpy(st.attacker),
                             defender=dmpc_state_to_numpy(st.defender))
    return DmpcState(*(a.detach().cpu().numpy() for a in st))


def dmpc_matchup(params: SimParams, B: int, opponent: str = "dmpc",
                 mpc: MpcParams | None = None,
                 strat: StrategyParams | None = None,
                 cbf: CbfParams | None = None, device="cuda"):
    """DMPC team A (field -1) against a DMPC, a CMPC or a no-op team B
    (+1) as a ``monte_carlo`` policy, with the CBF filter over all 4
    players' controls when ``cbf`` is given (the reference's dmpc
    pairings).  Returns (policy, initial policy state); per control step
    each DMPC team makes one K3 launch, a CMPC team one K4 launch."""
    if opponent not in ("dmpc", "cmpc", "noop"):
        raise ValueError(f"opponent must be 'dmpc', 'cmpc' or 'noop', got "
                         f"{opponent!r}")
    mpc = mpc or MpcParams()
    strat = strat or StrategyParams()
    dev = resolve_device(device)
    dtype = params.torch_dtype

    def policy(carry, states):
        ta, tb = carry
        ta, u_a = team_step_batch(ta, states.x, -1, params, mpc, strat)
        if opponent == "dmpc":
            tb, u_b = team_step_batch(tb, states.x, 1, params, mpc, strat)
        elif opponent == "cmpc":
            tb, u_b = cmpc_team_step_batch(tb, states.x, CMPC_OFFENSE, 1,
                                           params, mpc)
        else:
            u_b = torch.zeros_like(u_a)
        u = torch.cat([u_a, u_b], dim=1)                    # (B, 4, 2)
        if cbf is not None:
            u = safe_control_batch(u, states.x[:, :4, 0:2],
                                   states.x[:, :4, 2:4], params, cbf).u
        return (ta, tb), u

    init = lambda: initial_team_state(mpc, dtype, dev, (B,))
    init_b = {"dmpc": init,
              "cmpc": lambda: initial_cmpc_state(mpc, dtype, dev, (B,)),
              "noop": lambda: None}[opponent]
    return policy, (init(), init_b())


class DMPCPlayer:
    """Reference-API player (the reference's DMPCPlayer) on ``device``."""

    OFFENSE, DEFENSE = OFFENSE, DEFENSE
    ATTACKER, DEFENDER = ATTACKER, DEFENDER

    def __init__(self, sim_params: SimParams, mpc: MpcParams,
                 strat: StrategyParams, field: int, player_id: int,
                 device="cuda"):
        self.params = sim_params
        self.mpc = mpc
        self.strat = strat
        self.field = field
        self.player_id = player_id
        self.this_team = "A" if field < 0 else "B"
        self.device = resolve_device(device)
        self.cs = initial_dmpc_state(mpc, sim_params.torch_dtype, self.device)

    def get_action(self, play, state):
        """The player's velocity command (2,) as numpy for ``play`` and a
        SimStateView or flat 22-vector."""
        view = (state if isinstance(state, SimStateView)
                else SimStateView(state))
        x = view.entity_array.to(self.params.torch_dtype).to(self.device)
        puck = x[PUCK][None]
        tgt = player_target(torch.full((1,), int(play), dtype=torch.int32,
                                       device=self.device), self.player_id,
                            puck[:, 0:2], self.field, self.params,
                            self.strat)[0]
        rows = _rows(self.field)
        me = rows[0] if self.player_id == ATTACKER else rows[1]
        obs = torch.stack([x[r, 0:2] for r in (A1, A2, B1, B2) if r != me])
        self.cs, u = compute_control(self.cs, x[me], tgt, obs, self.params,
                                     self.mpc)
        return u.cpu().numpy()


class DMPCTeam:
    """Reference-API team (the reference's DMPCTeam) on ``device``."""

    def __init__(self, sim_params: SimParams, field: int, name: str = "",
                 mpc: MpcParams | None = None,
                 strat: StrategyParams | None = None, device="cuda"):
        self.params = sim_params
        self.field = field
        self.name = name
        self.mpc = mpc or MpcParams()
        self.strat = strat or StrategyParams()
        self.device = resolve_device(device)
        self.state = initial_team_state(self.mpc, sim_params.torch_dtype,
                                        self.device)

    def execute(self, sim_state):
        """(attacker, defender) velocity commands as numpy (2,) arrays."""
        view = (sim_state if isinstance(sim_state, SimStateView)
                else SimStateView(sim_state))
        x = view.entity_array.to(self.params.torch_dtype).to(self.device)
        self.state, us = team_step(self.state, x, self.field, self.params,
                                   self.mpc, self.strat)
        us = us.cpu().numpy()
        return us[0], us[1]
