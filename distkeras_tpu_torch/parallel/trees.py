"""Host parameter trees in ``jax.tree_util``'s order, without JAX.

The parameter-server wire of the JAX package carries a tree's leaves in
``jax.tree_util`` order: dicts by sorted key, lists and tuples in order,
recursively; ``None`` is an empty subtree.  The port's host PS holds the
same trees (the flax ``params`` tree of numpy leaves), so these helpers
walk them in exactly that order: ``tree_leaves`` of a tree here equals
``jax.tree_util.tree_leaves`` of it there, which is what makes
``host_ps.pack_params`` byte-identical across the packages.

``tree_unflatten(template, leaves)`` rebuilds ``template``'s structure
(dicts in sorted key order, as JAX rebuilds them) around ``leaves``.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch

Pytree = Any


def _children(tree) -> list | None:
    """The subtrees of a node in traversal order, or None for a leaf."""
    if isinstance(tree, Mapping):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    if tree is None:
        return []
    return None


def tree_leaves(tree: Pytree) -> list:
    out: list = []

    def walk(node):
        kids = _children(node)
        if kids is None:
            out.append(node)
        else:
            for k in kids:
                walk(k)

    walk(tree)
    return out


def tree_unflatten(template: Pytree, leaves) -> Pytree:
    """``template``'s structure filled with ``leaves`` in traversal
    order (a wrong count raises)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, Mapping):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        if node is None:
            return None
        return next(it)

    try:
        out = build(template)
    except StopIteration:
        raise ValueError("fewer leaves than the template has") from None
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the template has")
    return out


_END = object()


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in ``tree``'s structure."""
    leaves = tree_leaves(tree)
    others = [tree_leaves(r) for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(
                f"trees differ: {len(leaves)} against {len(o)} leaves")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(leaves, *others)])


def to_numpy(x) -> np.ndarray:
    """A leaf as a host numpy array (a tensor on any device is copied to
    the host; numpy passes through ``np.asarray``)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tree_to_numpy(tree: Pytree) -> Pytree:
    return tree_map(to_numpy, tree)
