"""The centralized-MPC team (the reference's BaselineCentralizedPlayers /
CentralizedTeam), batched over games.

Counterpart of the JAX package's ``agents/centralized.py``.  Per control
step the team gives its attacker (reach the puck with velocity v_hit = 5
toward the goal) and its defender (the midpoint between the home goal and
the puck, or attack when the puck is in the far half) a target state, and
one joint CMPC solves both players against the two opponents' current
positions.  :func:`team_step_batch` sends every game's candidates through
one :func:`..control.cmpc.compute_control_batch` (one K4 launch).  The
reference's CentralizedTeam always plays OFFENSE.

:func:`cmpc_matchup` pairs two CMPC teams as a ``monte_carlo`` policy,
optionally behind the CBF filter (the reference's bl_vs_bl matchup).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import (A1, A2, B1, B2, PUCK, CbfParams, MpcParams, SimParams,
                      resolve_device)
from ..control.cbf import safe_control_batch
from ..control.cmpc import (CmpcState, compute_control,
                            compute_control_batch, initial_cmpc_state)
from ..state import SimStateView

OFFENSE, DEFENSE = 0, 1
V_HIT = 5.0


def target_states(play, puck_pos, field: int, params: SimParams,
                  v_hit: float = V_HIT):
    """Attacker and defender target states (B, 4) each for plays (B,) and
    puck positions (B, 2)."""
    dtype, dev = puck_pos.dtype, puck_pos.device
    B = puck_pos.shape[0]
    gx = torch.full((B,), -field * params.arena_x / 2.0, dtype=dtype,
                    device=dev)
    zero = torch.zeros_like(gx)
    goal = torch.stack([gx, zero], dim=1)
    home = torch.stack([-gx, zero], dim=1)
    d = goal - puck_pos
    n = torch.sqrt((d * d).sum(-1, keepdim=True))
    hit = v_hit * d / torch.where(n > 0, n, torch.ones_like(n))
    x_attack_off = torch.cat([puck_pos, hit], dim=1)
    x_attack_def = torch.cat([puck_pos, 2.0 * hit], dim=1)
    offense = (play == OFFENSE)[:, None]
    x_attack = torch.where(offense, x_attack_off, x_attack_def)
    def_pos = home + (puck_pos - home) / 2.0
    x_def_home = torch.cat([def_pos, torch.zeros_like(def_pos)], dim=1)
    home_side = (field * puck_pos[:, 0] > 0)[:, None]
    x_defend = torch.where(offense, torch.where(home_side, x_def_home,
                                                x_attack_off), x_def_home)
    return x_attack, x_defend


def _rows(field: int):
    """(attacker, defender, opponent 1, opponent 2) entity rows."""
    return (A1, A2, B1, B2) if field < 0 else (B1, B2, A1, A2)


def team_inputs(x, play, field: int, params: SimParams):
    """Per game of x (B, 5, 4) and plays (B,): the attacker's and the
    defender's states and targets (B, 4) each and the obstacles (B, 2, 2),
    the opponents' positions."""
    a_row, d_row, o1, o2 = _rows(field)
    x_att, x_def = target_states(play, x[:, PUCK, 0:2], field, params)
    obstacles = torch.stack([x[:, o1, 0:2], x[:, o2, 0:2]], dim=1)
    return x[:, a_row], x[:, d_row], x_att, x_def, obstacles


def team_step_batch(cs: CmpcState, x, play, field: int, params: SimParams,
                    mpc: MpcParams, route: str = "fused"):
    """One control step of B games' CMPC teams: ``cs`` with (B, ...) leaves,
    x (B, 5, 4), ``play`` an int or (B,), ``field`` -1 (team A) or +1
    (team B).  Returns (new state, (B, 2, 2) [attacker, defender]
    velocities)."""
    B = x.shape[0]
    play_b = torch.as_tensor(play, device=x.device).expand(B)
    cs, u1, u2 = compute_control_batch(
        cs, *team_inputs(x, play_b, field, params), params, mpc, route)
    return cs, torch.stack([u1, u2], dim=1)


def team_step(cs: CmpcState, x, play, field: int, params: SimParams,
              mpc: MpcParams):
    """One game: ``cs`` with unbatched leaves, x (5, 4) on one device; the
    team solves with :func:`..control.cmpc.compute_control`.  Returns (new
    state, (2, 2) [attacker, defender])."""
    play_b = torch.as_tensor(play, device=x.device).reshape(1)
    xa, xd, ta, td, obs = (a[0] for a in team_inputs(x[None], play_b, field,
                                                     params))
    cs, u1, u2 = compute_control(cs, xa, xd, ta, td, obs, params, mpc)
    return cs, torch.stack([u1, u2])


def cmpc_state_from_numpy(st, device="cuda") -> CmpcState:
    """A CmpcState of tensors from one with array leaves of the same
    structure, e.g. the JAX package's warm state pulled to numpy; U and h
    keep their dtype, valid becomes bool."""
    dev = resolve_device(device)
    return CmpcState(U=torch.as_tensor(np.array(st.U)).to(dev),
                     valid=torch.as_tensor(np.array(st.valid)).to(
                         torch.bool).to(dev),
                     h=torch.as_tensor(np.array(st.h)).to(dev))


def cmpc_state_to_numpy(st: CmpcState) -> CmpcState:
    """The same CmpcState with numpy leaves."""
    return CmpcState(*(a.detach().cpu().numpy() for a in st))


def cmpc_matchup(params: SimParams, B: int, opponent: str = "cmpc",
                 mpc: MpcParams | None = None, cbf: CbfParams | None = None,
                 device="cuda"):
    """CMPC team A (field -1) against CMPC team B (+1) as a ``monte_carlo``
    policy, with the CBF filter over all 4 players' controls when ``cbf``
    is given (the reference's bl_vs_bl pairing).  Returns (policy, initial
    policy state); per control step each team makes one K4 launch."""
    if opponent != "cmpc":
        raise ValueError(f"opponent must be 'cmpc', got {opponent!r}")
    mpc = mpc or MpcParams()
    dev = resolve_device(device)
    dtype = params.torch_dtype

    def policy(carry, states):
        ca, cb = carry
        ca, u_a = team_step_batch(ca, states.x, OFFENSE, -1, params, mpc)
        cb, u_b = team_step_batch(cb, states.x, OFFENSE, 1, params, mpc)
        u = torch.cat([u_a, u_b], dim=1)                    # (B, 4, 2)
        if cbf is not None:
            u = safe_control_batch(u, states.x[:, :4, 0:2],
                                   states.x[:, :4, 2:4], params, cbf).u
        return (ca, cb), u

    init = lambda: initial_cmpc_state(mpc, dtype, dev, (B,))
    return policy, (init(), init())


class BaselineCentralizedPlayers:
    """Reference-API pair of players (the reference's
    BaselineCentralizedPlayers) on ``device``; ``field`` -1 is team A,
    +1 team B."""

    OFFENSE, DEFENSE = OFFENSE, DEFENSE

    def __init__(self, sim_params: SimParams, field: int,
                 player_id: int = 1, mpc: MpcParams | None = None,
                 device="cuda"):
        self.params = sim_params
        self.field = field
        self.this_team = "A" if field < 0 else "B"
        self.player_id = player_id
        self.v_hit = V_HIT
        self.mpc = mpc or MpcParams()
        self.device = resolve_device(device)
        self.cs = initial_cmpc_state(self.mpc, sim_params.torch_dtype,
                                     self.device)

    def get_action(self, play, state):
        """The attacker's and the defender's velocity commands as numpy (2,)
        arrays for ``play`` and a SimStateView or flat 22-vector."""
        view = (state if isinstance(state, SimStateView)
                else SimStateView(state))
        x = view.entity_array.to(self.params.torch_dtype).to(self.device)
        self.cs, u = team_step(self.cs, x, int(play), self.field,
                               self.params, self.mpc)
        u = u.cpu().numpy()
        return u[0], u[1]


class CentralizedTeam:
    """Always-offense team (the reference's CentralizedTeam) on
    ``device``."""

    def __init__(self, params: SimParams, field: int, team: str | None = None,
                 mpc: MpcParams | None = None, device="cuda"):
        self.players = BaselineCentralizedPlayers(params, field, 1, mpc,
                                                  device)

    def run(self, state):
        return self.players.get_action(OFFENSE, state)
