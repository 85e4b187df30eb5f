"""The plain reference of the ``dmpc_vs_cmpc`` pairing's policy: the DMPC
team A (field -1) against the CMPC team B (+1), :func:`mpc.matchup_policy`
read and answered in the program's carry layout."""

from __future__ import annotations

import torch

from . import mpc


def policy(x, carry, cfg: dict, dtype=torch.float32):
    """One control step for B games from the states ``x`` (B, 5, 4) and the
    program's carry ``((attacker, defender), cmpc)``, each (U, valid, h):
    the controls (B, 4, 2) and the new carry in the same layout."""
    (att, dfn), cst = carry
    dstate = tuple(torch.stack([a, d], dim=1) for a, d in zip(att, dfn))
    u, dnew, cnew = mpc.matchup_policy(x, dstate, tuple(cst),
                                       cfg["SimParams"], cfg["MpcParams"],
                                       cfg["StrategyParams"], dtype)
    return u, ((tuple(a[:, 0] for a in dnew),
                tuple(a[:, 1] for a in dnew)), cnew)
