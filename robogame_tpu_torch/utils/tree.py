"""Nests of named tuples, tuples, lists and dicts with tensors (or other
values) at the leaves: the game state, a policy's carry, a checkpoint's
contents.  ``None`` is an empty nest; dicts go in sorted key order."""

from __future__ import annotations


def _is_named(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def leaves(tree) -> list:
    """The leaves of ``tree`` in order."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [x for sub in tree for x in leaves(sub)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def structure(tree) -> str:
    """A printable description of the nest's shape (``*`` a leaf)."""
    if tree is None:
        return "None"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(structure(x) for x in tree)
        name = type(tree).__name__ if _is_named(tree) else ""
        return f"{name}({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    return "*"


def unflatten(like, values):
    """A nest of ``like``'s shape with ``values`` at its leaves."""
    it = iter(values)

    def build(t):
        if t is None:
            return None
        if isinstance(t, (tuple, list)):
            parts = [build(x) for x in t]
            if _is_named(t):
                return type(t)(*parts)
            return type(t)(parts)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(like)


def tree_map(fn, tree):
    """``fn`` applied to every leaf, the nest's shape kept."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])
