"""Nested dicts of tensors (the port's param, gradient and optimizer-state
trees), flattened and mapped in the JAX package's leaf order: dict keys
sorted, as ``jax.tree_util`` flattens dicts.  The order matters where leaves
are summed (the gradient norm) and where parity tests pair leaves."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves_with_paths(tree, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path, leaf)] in sorted-key order; a leaf is anything but a dict."""
    if not isinstance(tree, dict):
        return [(path, tree)]
    out = []
    for k in sorted(tree):
        out.extend(leaves_with_paths(tree[k], path + (k,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of ``rest`` (same structure)."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}


def tree_from_paths(pairs) -> dict:
    """The nested dict of ``leaves_with_paths``' (path, leaf) pairs."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
