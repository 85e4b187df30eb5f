"""Binary game logs in the reference's on-disk format (numpy only).

The reference Logger appends raw doubles, 29 per control step: ``t,
scoreA, scoreB``, then the positions (2 each) of puck, A1, A2, B1, B2,
then the 4x4 damage matrix as 4 rows.  Files written here are
byte-compatible, so the reference's MATLAB readers work unchanged.

A reference quirk is kept for byte-compatibility: the Logger emits
``damage.row(k)`` through the raw ``.data()`` pointer of a row *block* of
a column-major matrix.  ``.data()`` points at ``&damage(k,0)``, so each
"row" writes the next 4 *contiguous column-major* elements -- a sliding
window ``cmflat[k:k+4]`` of the column-major flattening.  The 16 logged
damage fields are therefore cmflat[0:4], [1:5], [2:6], [3:7]: entries
cmflat[7:] never reach the log and early entries repeat.
:func:`rows_from_states_full_damage` offers a lossless 41-field export for
new tooling.
"""

from __future__ import annotations

import numpy as np

RECORD_FIELDS = 29


class GameLogWriter:
    """Binary log writer: the native asynchronous C++ logger
    (``native/logger.cpp``) where it builds, so host control loops never
    block on disk, else a synchronous numpy writer.  Pass ``native=False``
    for the numpy writer; :attr:`writer` names the one that runs."""

    def __init__(self, path: str, native: bool = True):
        self._native = None
        if native:
            from ..native import NativeLogger, available
            if available():
                self._native = NativeLogger(path)
        self._f = None if self._native else open(path, "wb")

    @property
    def writer(self) -> str:
        """``"native"`` (the C++ logger) or ``"numpy"``."""
        return "native" if self._native is not None else "numpy"

    def write_row(self, row: np.ndarray):
        if self._native:
            self._native.write(row)
        else:
            np.asarray(row, dtype="<f8").reshape(-1).tofile(self._f)

    def write_rows(self, rows: np.ndarray):
        if self._native:
            self._native.write(rows)
        else:
            np.asarray(rows, dtype="<f8").tofile(self._f)

    def close(self):
        if self._native:
            self._native.close()
            self._native = None
        elif self._f is not None and not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_log(path: str, fields: int = RECORD_FIELDS) -> np.ndarray:
    """Read a binary log into an (n_steps, fields) float64 array."""
    data = np.fromfile(path, dtype="<f8")
    n = data.size // fields
    return data[:n * fields].reshape(n, fields)


# sliding-window gather indices into the column-major damage flattening
# (see module docstring)
DAMAGE_WINDOW_IDX = np.array([0, 1, 2, 3, 1, 2, 3, 4,
                              2, 3, 4, 5, 3, 4, 5, 6])


def damage_log_fields(damage: np.ndarray) -> np.ndarray:
    """(.., 4, 4) damage -> (.., 16) log fields, reference quirk included."""
    dm = np.asarray(damage, dtype=np.float64)
    cm = np.swapaxes(dm, -1, -2).reshape(dm.shape[:-2] + (16,))
    return cm[..., DAMAGE_WINDOW_IDX]


def rows_from_states(ts, scores, positions, damages) -> np.ndarray:
    """Build (T, 29) rows from trajectory arrays.

    positions: (T, 5, 2) in log order [puck, A1, A2, B1, B2];
    damages: (T, 4, 4), emitted through the reference's sliding-window quirk.
    """
    T = np.shape(ts)[0]
    out = np.empty((T, RECORD_FIELDS), dtype=np.float64)
    out[:, 0] = np.asarray(ts, dtype=np.float64)
    out[:, 1:3] = np.asarray(scores, dtype=np.float64).reshape(T, 2)
    out[:, 3:13] = np.asarray(positions, dtype=np.float64).reshape(T, 10)
    out[:, 13:29] = damage_log_fields(damages)
    return out


def rows_from_states_full_damage(ts, scores, positions, damages):
    """Lossless 41-field export: 13 header fields + the full row-major
    damage matrix (new tooling should prefer this)."""
    T = np.shape(ts)[0]
    out = np.empty((T, 13 + 16), dtype=np.float64)
    out[:, 0] = np.asarray(ts, dtype=np.float64)
    out[:, 1:3] = np.asarray(scores, dtype=np.float64).reshape(T, 2)
    out[:, 3:13] = np.asarray(positions, dtype=np.float64).reshape(T, 10)
    out[:, 13:29] = np.asarray(damages, dtype=np.float64).reshape(T, 16)
    return out


def _host(a) -> np.ndarray:
    """A numpy copy of an array or of a tensor on any device."""
    if hasattr(a, "detach"):
        a = a.detach().cpu()
    return np.asarray(a)


def write_trajectory_log(path: str, recs) -> None:
    """Write one game's stacked LogRecord (from ``scripted_rollout``, its
    fields (T, ...)) to disk."""
    rows = rows_from_states(_host(recs.t), _host(recs.score),
                            _host(recs.positions), _host(recs.damage))
    with GameLogWriter(path) as w:
        w.write_rows(rows)
