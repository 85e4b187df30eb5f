"""``GameSim``: the reference's pybind11 surface over the port.

The reference exposes ``GameSim`` with ``reset`` / ``undecided`` / ``run``;
this class gives the same surface over :func:`.physics.step.step_batch`
(a batch of one game on ``device``), returning the flat 22-vector as
numpy.  Every reset parameter is keyword-optional with the C++ default
values.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import SimParams, resolve_device
from .physics.rollout import log_record
from .physics.step import step_batch
from .state import GameState, initial_state, to_vector, undecided
from .utils.gamelog import GameLogWriter, damage_log_fields


class GameSim:
    """One game stepped by the port's engine (``params.engine``, "event"
    by default) on ``device`` (cuda unless the caller asks for the CPU).
    :attr:`state` is a batch of one."""

    def __init__(self, params: SimParams | None = None, device="cuda"):
        self._params = params or SimParams()
        self._device = resolve_device(device)
        self._state: GameState | None = None
        self._log: GameLogWriter | None = None

    def reset(self, dt: float = 0.05, winning_score: int = 3,
              x0_ball=None, noise: float = 0.0, log: bool = False,
              logname: str = "gamelog.log", seed: int = 0,
              tau_puck: float = 0.1, tau_player: float = 0.5,
              player_mass: float = 1.0, puck_mass: float = 0.5):
        """The signature and defaults of the reference's
        ``GameSim::reset``."""
        self._params = self._params.replace(
            dt=dt, winning_score=winning_score, noise=noise,
            tau_puck=tau_puck, tau_player=tau_player,
            player_mass=player_mass, puck_mass=puck_mass,
            stochastic=noise != 0.0)
        self._state = initial_state(self._params, x0_puck=x0_ball, seed=seed,
                                    device=self._device)
        if self._log is not None:
            self._log.close()
            self._log = None
        if log:
            self._log = GameLogWriter(logname)
        return self._vector()

    def undecided(self) -> bool:
        return bool(undecided(self._state, self._params)[0])

    def run(self, vel_A1, vel_A2, vel_B1, vel_B2):
        """One control step with the four players' commanded velocities;
        a decided game is frozen and, as in the reference, no longer
        logged."""
        u = np.stack([np.asarray(v, dtype=np.float64).reshape(2)
                      for v in (vel_A1, vel_A2, vel_B1, vel_B2)])
        u = torch.as_tensor(u, dtype=self._params.torch_dtype,
                            device=self._device)[None]
        was_undecided = self.undecided()
        self._state = step_batch(self._state, u, self._params,
                                 device=self._device)
        if self._log is not None and was_undecided:
            rec = log_record(self._state)
            host = lambda a: a[0].cpu().numpy().astype(np.float64)
            self._log.write_row(np.concatenate([
                host(rec.t).reshape(1), host(rec.score),
                host(rec.positions).reshape(10),
                # the reference Logger's sliding-window damage emission
                damage_log_fields(host(rec.damage))]))
        return self._vector()

    def close(self) -> None:
        """Close the log, if one is open."""
        if self._log is not None:
            self._log.close()
            self._log = None

    def _vector(self) -> np.ndarray:
        return to_vector(self._state)[0].cpu().numpy()

    @property
    def state(self) -> GameState:
        return self._state

    @property
    def params(self) -> SimParams:
        return self._params

    @property
    def log_writer(self) -> str | None:
        """The open log's writer, ``"native"`` or ``"numpy"`` (None when
        the game is not logged)."""
        return None if self._log is None else self._log.writer
