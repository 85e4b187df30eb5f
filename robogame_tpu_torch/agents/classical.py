"""The classical 2-player team state machine, batched over games.

Counterpart of the JAX package's ``agents/classical.py`` (the reference's
ClassicalTeam): :func:`team_policy_batch` is one control step of B games'
teams as ``(TeamState, x) -> (TeamState, controls)``.  Plays are open loop:
each step evaluates the play, solves the 5 candidate skill trajectories of
every game in one :func:`..control.trajopt.min_time_traj_batch` (one K2
launch for all B x 5 x 16 final-time candidates), and installs a fresh
trajectory only where the reference's state machine re-plans (a player
that is idle, or both players when the play flips).

:func:`classical_matchup` pairs two teams, optionally behind the CBF
safety filter, as a ``monte_carlo`` policy.

:class:`ClassicalPlayer` is the reference's single player with its seven
skills and open-loop playback, on one device: the min-time skills
(``simple_kick``, ``defend_kick``, ``defend``) plan through
:func:`..control.trajopt.min_time_traj` (K2 on the card), the others
through the fixed-final-time, bounce and obstacle planners
(``control/trajopt.py``, ``contact.py``, ``obstacles.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import (A1, A2, B1, B2, PUCK, CbfParams, SimParams,
                      StrategyParams, resolve_device)
from ..control.cbf import safe_control_batch
from ..control.contact import bounce_pass_wall
from ..control.obstacles import (_obs_arrays,
                                 intercepting_with_obs_avoidance,
                                 min_time_traj_avoid_obs)
from ..control.trajopt import (MAX_TRAJ, Trajectory, intercepting_traj,
                               min_time_bounce_kick_traj, min_time_traj,
                               min_time_traj_batch)
from ..state import SimStateView

OFFENSE, DEFENSE = 0, 1


class PlayerState(NamedTuple):
    """Open-loop playback state: the current control trajectory and the
    evaluation index."""
    u_traj: torch.Tensor   # (B, 2, MAX_TRAJ)
    t_idx: torch.Tensor    # (B,) int32
    length: torch.Tensor   # (B,) int32


class TeamState(NamedTuple):
    goalie: PlayerState
    player: PlayerState
    curr_play: torch.Tensor  # (B,) int32, OFFENSE/DEFENSE


def idle_player(B: int, dtype=torch.float32, device="cuda") -> PlayerState:
    """B zero-length trajectories (the reference's idle())."""
    dev = resolve_device(device)
    return PlayerState(
        u_traj=torch.zeros((B, 2, MAX_TRAJ), dtype=dtype, device=dev),
        t_idx=torch.zeros((B,), dtype=torch.int32, device=dev),
        length=torch.ones((B,), dtype=torch.int32, device=dev))


def initial_team_state(B: int, dtype=torch.float32,
                       device="cuda") -> TeamState:
    dev = resolve_device(device)
    return TeamState(goalie=idle_player(B, dtype, dev),
                     player=idle_player(B, dtype, dev),
                     curr_play=torch.full((B,), DEFENSE, dtype=torch.int32,
                                          device=dev))


def is_idle(ps: PlayerState) -> torch.Tensor:
    """(t_idx+1)/length >= 1."""
    return (ps.t_idx + 1) >= ps.length


def get_control(ps: PlayerState):
    """Open-loop playback: emit u_traj[:, :, t_idx] (B, 2) and advance;
    past the end, go idle and emit zeros."""
    ok = (ps.t_idx + 1) <= ps.length
    col = ps.t_idx.clamp(0, MAX_TRAJ - 1).long()
    u = torch.gather(ps.u_traj, 2, col[:, None, None].expand(-1, 2, 1))[..., 0]
    zero = torch.zeros((), dtype=ps.u_traj.dtype, device=ps.u_traj.device)
    u = torch.where(ok[:, None], u, zero)
    nxt = PlayerState(
        u_traj=torch.where(ok[:, None, None], ps.u_traj, zero),
        t_idx=torch.where(ok, ps.t_idx + 1, torch.zeros_like(ps.t_idx)),
        length=torch.where(ok, ps.length, torch.ones_like(ps.length)))
    return u, nxt


def _select(mask, a: PlayerState, b: PlayerState) -> PlayerState:
    """a where ``mask`` (B,) else b, leaf by leaf."""
    return PlayerState(
        u_traj=torch.where(mask[:, None, None], a.u_traj, b.u_traj),
        t_idx=torch.where(mask, a.t_idx, b.t_idx),
        length=torch.where(mask, a.length, b.length))


def _apply_traj(ps: PlayerState, traj: Trajectory, do) -> PlayerState:
    """Install a freshly planned trajectory where ``do & traj.success``
    (the min-time skills only overwrite on success)."""
    take = do & traj.success
    return _select(take, PlayerState(traj.u, torch.zeros_like(ps.t_idx),
                                     traj.length), ps)


def _norm(v):
    return torch.sqrt((v * v).sum(-1))


def kick_final_state(p_goal, p_puck, kick_velocity, params: SimParams):
    """pf = p_puck - dir (r_puck + r_player), vf = kick_vel dir, for (B, 2)
    goals and pucks."""
    d = p_goal - p_puck
    n = _norm(d)[:, None]
    d = torch.where(n > 1e-4, d / torch.where(n > 0, n, torch.ones_like(n)),
                    d)
    pf = p_puck - d * (params.puck_radius + params.player_radius)
    return pf, kick_velocity * d


def _normalize(v):
    n = _norm(v)[:, None]
    return torch.where(n > 0, v / torch.where(n > 0, n, torch.ones_like(n)),
                       v)


def _rows(field: int):
    """(goalie, player, opponent 1, opponent 2) entity rows."""
    return (A1, A2, B1, B2) if field < 0 else (B1, B2, A1, A2)


def _team_candidates(x, field: int, params: SimParams,
                     strat: StrategyParams):
    """Per-game pre-solve math of the state machine for x (B, 5, 4): the 5
    candidate skill problems (player simple_kick / defend_kick at 1.5 kv,
    goalie defend / kick / defend_kick) as (B, 5, 2) p0, v0, pf, vf, and
    the play selection (B,)."""
    dtype, dev = x.dtype, x.device
    B = x.shape[0]
    kv = strat.kick_velocity
    g_row, p_row, o1_row, o2_row = _rows(field)
    puck = x[:, PUCK]
    gx = torch.full((B,), -field * params.arena_x / 2.0, dtype=dtype,
                    device=dev)
    goal = torch.stack([gx, torch.zeros_like(gx)], dim=1)
    home = torch.stack([-gx, torch.zeros_like(gx)], dim=1)

    # play selection (ClassicalTeam.evaluateGame)
    defend = (field * puck[:, 0] >= params.arena_x / 4.0) & \
        (field * puck[:, 2] >= 0)
    next_play = torch.where(defend, DEFENSE, OFFENSE).to(torch.int32)

    pf_kick, vf_kick = kick_final_state(goal, puck[:, 0:2], kv, params)
    # defend_kick: open-field shot away from the opponents' mean y side
    opp_y = x[:, o1_row, 1] + x[:, o2_row, 1]
    dk_dir = _normalize(torch.stack(
        [torch.full_like(opp_y, -field), torch.sign(opp_y)], dim=1))
    pf_dk = puck[:, 0:2] - dk_dir * (params.puck_radius +
                                     params.player_radius)
    # goalie defend point: halfway between home and the puck
    pf_def = home + 0.5 * (puck[:, 0:2] - home)

    z = torch.zeros_like(pf_def)
    xp, xg = x[:, p_row], x[:, g_row]
    cand_p0 = torch.stack([xp[:, 0:2], xp[:, 0:2], xg[:, 0:2], xg[:, 0:2],
                           xg[:, 0:2]], dim=1)
    cand_v0 = torch.stack([xp[:, 2:4], xp[:, 2:4], xg[:, 2:4], xg[:, 2:4],
                           xg[:, 2:4]], dim=1)
    cand_pf = torch.stack([pf_kick, pf_dk, pf_def, pf_kick, pf_dk], dim=1)
    cand_vf = torch.stack([vf_kick, 1.5 * kv * dk_dir, z, vf_kick,
                           kv * dk_dir], dim=1)
    return cand_p0, cand_v0, cand_pf, cand_vf, next_play


def _team_apply(ts: TeamState, x, trajs: Trajectory, next_play,
                field: int):
    """Post-solve half of the state machine: play-flip idling, masked
    trajectory installs, open-loop playback.  ``trajs`` leaves are
    (B, 5, ...), candidates in :func:`_team_candidates`' order."""
    B = x.shape[0]
    puck = x[:, PUCK]
    _, _, o1_row, o2_row = _rows(field)
    flipped = next_play != ts.curr_play
    idle = idle_player(B, ts.goalie.u_traj.dtype, x.device)
    goalie = _select(flipped, idle, ts.goalie)
    player = _select(flipped, idle, ts.player)

    t_simple, t_dk15, t_def, t_gkick, t_gdk = [
        Trajectory(*(a[:, i] for a in trajs)) for i in range(5)]

    offense = next_play == OFFENSE
    p_idle = is_idle(player)
    player = _apply_traj(player, t_simple, p_idle & offense)
    player = _apply_traj(player, t_dk15, p_idle & ~offense)

    g_idle = is_idle(goalie)
    # offense: defend if the puck is in the home half, else kick
    home_half = field * puck[:, 0] >= 0
    goalie = _apply_traj(goalie, t_def, g_idle & offense & home_half)
    goalie = _apply_traj(goalie, t_gkick, g_idle & offense & ~home_half)
    # defense: kick away if closest to the puck, else defend.  Reference
    # quirk kept: "goalie distance" reads the ADVERSARY team's player 1
    # (ClassicalTeam.py:65), so it equals d1 and the kick never fires.
    gd = _norm(x[:, o1_row, 0:2] - puck[:, 0:2])
    d1 = _norm(x[:, o1_row, 0:2] - puck[:, 0:2])
    d2 = _norm(x[:, o2_row, 0:2] - puck[:, 0:2])
    closest = (gd < d1) & (gd < d2)
    goalie = _apply_traj(goalie, t_gdk, g_idle & ~offense & closest)
    goalie = _apply_traj(goalie, t_def, g_idle & ~offense & ~closest)

    u_g, goalie = get_control(goalie)
    u_p, player = get_control(player)
    ts2 = TeamState(goalie=goalie, player=player, curr_play=next_play)
    return ts2, torch.stack([u_g, u_p], dim=1)


def team_policy_batch(ts: TeamState, x, field: int, params: SimParams,
                      strat: StrategyParams):
    """One control step of B games' teams: ``ts`` with (B, ...) leaves, x
    (B, 5, 4) entity states, ``field`` -1 (team A, defends the left) or +1
    (team B).  Returns (new TeamState, (B, 2, 2) controls [goalie,
    player]).  All B x 5 candidate skills (x 16 final times) solve in one
    K2 launch."""
    B = x.shape[0]
    cand_p0, cand_v0, cand_pf, cand_vf, next_play = _team_candidates(
        x, field, params, strat)
    flat = [a.reshape(B * 5, 2) for a in (cand_p0, cand_v0, cand_pf,
                                          cand_vf)]
    tr = min_time_traj_batch(*flat, params)
    trajs = Trajectory(*(a.reshape((B, 5) + a.shape[1:]) for a in tr))
    return _team_apply(ts, x, trajs, next_play, field)


def _map(fn, ts: TeamState) -> TeamState:
    return TeamState(goalie=PlayerState(*(fn(a) for a in ts.goalie)),
                     player=PlayerState(*(fn(a) for a in ts.player)),
                     curr_play=fn(ts.curr_play))


def team_policy(ts: TeamState, x, field: int, params: SimParams,
                strat: StrategyParams):
    """One game: ``ts`` with unbatched leaves and x (5, 4) on one device;
    :func:`team_policy_batch` at B=1.  Returns (TeamState, (2, 2))."""
    ts2, u = team_policy_batch(_map(lambda a: a[None], ts), x[None], field,
                               params, strat)
    return _map(lambda a: a[0], ts2), u[0]


def team_state_from_numpy(ts, device="cuda") -> TeamState:
    """A TeamState of tensors from one with array leaves of the same
    structure (goalie/player u_traj, t_idx, length; curr_play), e.g. a
    JAX ``TeamState`` pulled to numpy; u_traj keeps its dtype."""
    dev = resolve_device(device)

    def player(ps):
        return PlayerState(
            u_traj=torch.as_tensor(np.array(ps.u_traj)).to(dev),
            t_idx=torch.as_tensor(np.array(ps.t_idx)).to(torch.int32).to(dev),
            length=torch.as_tensor(np.array(ps.length)).to(
                torch.int32).to(dev))

    return TeamState(goalie=player(ts.goalie), player=player(ts.player),
                     curr_play=torch.as_tensor(np.array(ts.curr_play)).to(
                         torch.int32).to(dev))


def team_state_to_numpy(ts: TeamState) -> TeamState:
    """The same TeamState with numpy leaves (host copies)."""
    return _map(lambda a: a.detach().cpu().numpy(), ts)


def classical_matchup(params: SimParams, B: int,
                      strat: StrategyParams | None = None,
                      cbf: CbfParams | None = None, device="cuda"):
    """Classical team A (field -1) against classical team B (+1) as a
    ``monte_carlo`` policy, with the CBF filter over all 4 players'
    controls when ``cbf`` is given.  Returns (policy, initial policy
    state); per control step the policy makes 2 K2 launches for the teams'
    skills and one for the CBF filter."""
    strat = strat or StrategyParams()
    dev = resolve_device(device)
    dtype = params.torch_dtype

    def policy(carry, states):
        ta, tb = carry
        ta, u_a = team_policy_batch(ta, states.x, -1, params, strat)
        tb, u_b = team_policy_batch(tb, states.x, 1, params, strat)
        u = torch.cat([u_a, u_b], dim=1)                    # (B, 4, 2)
        if cbf is not None:
            u = safe_control_batch(u, states.x[:, :4, 0:2],
                                   states.x[:, :4, 2:4], params, cbf).u
        return (ta, tb), u

    return policy, (initial_team_state(B, dtype, dev),
                    initial_team_state(B, dtype, dev))


class ClassicalPlayer:
    """The reference's skill player on ``device`` (cuda unless the caller
    asks for the CPU).  ``field``: -1 defends the left, +1 the right;
    ``team``: "A" or "B"; ``player_id``: 1 or 2.  :attr:`state` is one
    unbatched :class:`PlayerState` on the device; a skill plans a
    trajectory and installs it (the min-time skills only on success) and
    returns whether it succeeded; :meth:`get_control` plays it back."""

    def __init__(self, params: SimParams, field: int, team: str,
                 player_id: int, strat: StrategyParams | None = None,
                 device="cuda"):
        self.params = params
        self.field = field
        self.team = team
        self.player_id = player_id
        self.strat = strat or StrategyParams()
        self.device = resolve_device(device)
        self.idle()

    # -- playback ----------------------------------------------------------
    def get_control(self):
        """The next control (numpy (2,)) and the task's completed share
        before it, at most 1."""
        pct = self.task_percentage_completed()
        u, state = get_control(PlayerState(*(a[None] for a in self.state)))
        self.state = PlayerState(*(a[0] for a in state))
        return u[0].cpu().numpy(), min(pct, 1.0)

    def is_idle(self) -> bool:
        return bool(is_idle(self.state))

    def task_percentage_completed(self) -> float:
        return float((self.state.t_idx + 1) / self.state.length)

    def idle(self):
        self.state = PlayerState(*(a[0] for a in idle_player(
            1, self.params.torch_dtype, self.device)))
        return True

    # -- geometry helpers ----------------------------------------------------
    def get_adversary_goal_pos(self):
        return np.array([-self.field * self.params.arena_x / 2.0, 0.0])

    def get_home_goal_pos(self):
        return np.array([self.field * self.params.arena_x / 2.0, 0.0])

    def get_adversary_team(self):
        return {"A": "B", "B": "A"}[self.team]

    def get_teammate_id(self):
        return {1: 2, 2: 1}[self.player_id]

    def _t(self, a) -> torch.Tensor:
        """An array or tensor as a tensor on the device in the dtype."""
        return torch.as_tensor(a, dtype=self.params.torch_dtype).to(
            self.device)

    def _me(self, state: SimStateView):
        return (self._t(state.get_player_pos(self.team, self.player_id)),
                self._t(state.get_player_vel(self.team, self.player_id)))

    def _others(self, state: SimStateView):
        adv = self.get_adversary_team()
        return [state.get_player_pos(self.team, self.get_teammate_id()),
                state.get_player_pos(adv, 1), state.get_player_pos(adv, 2)]

    def _obstacles(self, state: SimStateView):
        return _obs_arrays(self._others(state), state.get_puck_pos(),
                           self.params, self.params.torch_dtype,
                           device=self.device)

    def _kick_target(self, state: SimStateView, kick_velocity):
        pf, vf = kick_final_state(self._t(self.get_adversary_goal_pos())[None],
                                  self._t(state.get_puck_pos())[None],
                                  kick_velocity, self.params)
        return pf[0], vf[0]

    def _install(self, traj: Trajectory, only_on_success: bool = True):
        ok = bool(traj.success)
        if ok or not only_on_success:
            self.state = PlayerState(
                u_traj=traj.u.to(self.params.torch_dtype),
                t_idx=torch.zeros((), dtype=torch.int32, device=self.device),
                length=traj.length.to(torch.int32))
        return ok

    # -- skills --------------------------------------------------------------
    def timed_kick(self, state, kick_velocity, time_to_kick):
        """Reach the kick state in ``time_to_kick`` (terminal equality,
        minimum effort); installed whatever the outcome."""
        pf, vf = self._kick_target(state, kick_velocity)
        p0, v0 = self._me(state)
        n = max(1, int(round(time_to_kick / self.params.dt)))
        traj = intercepting_traj(p0, v0, pf, vf, self.params, n,
                                 device=self.device)
        return self._install(traj, only_on_success=False)

    def timed_kick_avoiding_obs(self, state, kick_velocity, time_to_kick):
        pf, vf = self._kick_target(state, kick_velocity)
        p0, v0 = self._me(state)
        n = max(1, int(round(time_to_kick / self.params.dt)))
        traj = intercepting_with_obs_avoidance(
            p0, v0, pf, vf, *self._obstacles(state), self.params, n,
            device=self.device)
        return self._install(traj, only_on_success=False)

    def simple_kick(self, state, kick_velocity):
        pf, vf = self._kick_target(state, kick_velocity)
        p0, v0 = self._me(state)
        return self._install(min_time_traj(p0, v0, pf, vf, self.params,
                                           device=self.device))

    def simple_kick_avoiding_obs(self, state, kick_velocity):
        pf, vf = self._kick_target(state, kick_velocity)
        p0, v0 = self._me(state)
        return self._install(min_time_traj_avoid_obs(
            p0, v0, pf, vf, *self._obstacles(state), self.params,
            device=self.device))

    def bounce_kick(self, state, which_wall):
        """Bank the puck off a wall into the goal (needs tau_puck >= 1)."""
        plan = bounce_pass_wall(state.get_puck_pos(),
                                self.get_adversary_goal_pos(), which_wall,
                                self.params, device=self.device)
        if not bool(plan.success):
            return False
        p0, v0 = self._me(state)
        traj = min_time_bounce_kick_traj(
            p0, v0, state.get_puck_pos(), state.get_puck_vel(), plan.v0,
            self.params, device=self.device)
        return self._install(traj)

    def defend_kick(self, state, kick_vel):
        adv = self.get_adversary_team()
        opp_y = float(state.get_player_pos(adv, 1)[1] +
                      state.get_player_pos(adv, 2)[1])
        d = _normalize(self._t([-float(self.field),
                                float(np.sign(opp_y))])[None])[0]
        p_puck = self._t(state.get_puck_pos())
        pf = p_puck - d * (self.params.puck_radius +
                           self.params.player_radius)
        p0, v0 = self._me(state)
        return self._install(min_time_traj(p0, v0, pf, kick_vel * d,
                                           self.params, device=self.device))

    def defend(self, state):
        home = self._t(self.get_home_goal_pos())
        pf = home + 0.5 * (self._t(state.get_puck_pos()) - home)
        p0, v0 = self._me(state)
        return self._install(min_time_traj(
            p0, v0, pf, torch.zeros_like(pf), self.params,
            device=self.device))


class ClassicalTeam:
    """Reference-API team (the reference's ClassicalTeam): a stateful
    wrapper over :func:`team_policy` on ``device``."""

    def __init__(self, params: SimParams, field: int, team: str,
                 strat: StrategyParams | None = None, device="cuda"):
        self.params = params
        self.field = field
        self.team = team
        self.strat = strat or StrategyParams()
        self.device = resolve_device(device)
        self.state = _map(lambda a: a[0], initial_team_state(
            1, params.torch_dtype, self.device))

    def run(self, sim_state):
        """sim_state: SimStateView or flat 22-vector.  Returns
        (vel_goalie, vel_player) as numpy (2,) arrays."""
        view = (sim_state if isinstance(sim_state, SimStateView)
                else SimStateView(sim_state))
        x = view.entity_array.to(self.params.torch_dtype).to(self.device)
        self.state, u = team_policy(self.state, x, self.field, self.params,
                                    self.strat)
        u = u.cpu().numpy()
        return u[0], u[1]
