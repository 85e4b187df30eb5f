"""The comparisons that decide ``correct``.

Each number compared is a gap between what the timed path produced and
what the plain reference (``reference/``) works out from the same inputs,
per answer (a game at a step), in float64; a NaN or an infinity reads as
an infinite gap.  A cell's configuration holds each number's limit under
``limits``; ``PERF.md`` gives the readings each limit was set from.
"""

from __future__ import annotations

import torch


def field_gap(a, b) -> torch.Tensor:
    """Per-row max |a - b| over every other axis, float64 on the CPU."""
    a = torch.as_tensor(a).detach().cpu().to(torch.float64)
    b = torch.as_tensor(b).detach().cpu().to(torch.float64)
    d = (a - b).abs().reshape(a.shape[0], -1)
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))
    return d.amax(dim=1) if d.shape[1] else d.new_zeros(a.shape[0])


def state_gap(got, want) -> torch.Tensor:
    """Per game, the widest gap over the fields of two states given as
    tuples of the same order."""
    gaps = [field_gap(a, b) for a, b in zip(got, want)]
    return torch.stack(gaps).amax(dim=0)


def reading(name: str, gaps, limits: dict):
    """(name, widest gap, limit) and how many answers break the limit, from
    a list of per-answer gap tensors; with no answer compared the reading
    is infinite: nothing was shown correct."""
    lim = float(limits[name])
    if not gaps:
        return (name, float("inf"), lim), 1
    gaps = torch.cat(gaps)
    return (name, float(gaps.max()), lim), int((gaps > lim).sum())


def miss_share(got, want, atol: float, rtol: float) -> tuple:
    """From lists of controls (tensors of (n, 2) rows): the share of
    controls of which a component lies
    further than atol + rtol |want| from the reference's, and their count:
    where two f32 solvers part (an argmin flipped by roundoff between two
    near-equal candidates, a solve stopped at another point of a flat
    valley), a control misses; a wrong solver misses nearly everywhere."""
    if not got:
        return 1.0, 1                     # nothing compared: all missed
    got = torch.cat(got).detach().cpu().to(torch.float64)
    want = torch.cat(want).detach().cpu().to(torch.float64)
    far = ~((got - want).abs() <= atol + rtol * want.abs())
    miss = far.reshape(far.shape[0], -1).any(dim=1)
    return float(miss.double().mean()), int(miss.sum())


def leaves(tree) -> list:
    """The tensors of nested tuples, in order (None holds none)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for t in tree for leaf in leaves(t)]


def tree_miss(got, want, atol: float, rtol: float) -> torch.Tensor:
    """Per row (the leading axis, a game) of two carries of one layout:
    True where some floating entry lies further than atol + rtol |want|
    from the reference's, or some other entry differs.  Carries of
    different layouts miss on every row."""
    a_s, b_s = leaves(got), leaves(want)
    rows = torch.as_tensor(a_s[0] if a_s else b_s[0]).shape[0]
    if len(a_s) != len(b_s) or any(a.shape != b.shape
                                   for a, b in zip(a_s, b_s)):
        return torch.ones(rows, dtype=torch.bool)
    miss = torch.zeros(rows, dtype=torch.bool)
    for a, b in zip(a_s, b_s):
        a, b = a.detach().cpu(), b.detach().cpu()
        if a.is_floating_point() or b.is_floating_point():
            a, b = a.to(torch.float64), b.to(torch.float64)
            far = ~((a - b).abs() <= atol + rtol * b.abs())
        else:
            far = a != b
        miss |= far.reshape(rows, -1).any(dim=1)
    return miss


def share(misses: list) -> tuple:
    """(share, count) of True over a list of per-row miss tensors; with
    nothing compared, all missed."""
    if not misses:
        return 1.0, 1
    m = torch.cat(misses)
    return float(m.double().mean()), int(m.sum())
