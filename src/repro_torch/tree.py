"""Param and state trees: nested dicts and lists with tensor leaves.

The port's stand-in for the parts of ``jax.tree_util`` that the model,
training and checkpoints use. Dicts and lists are nodes; anything else,
a tuple included, is a leaf (the DiT's forward maps over a tree whose
leaves are the tuples of a stacked leaf's unbound layers). Leaves come in
JAX's order (dict keys sorted, lists in order), so the i-th leaf of a
tree here is the i-th leaf of the same tree in the reference: the
optimizer's moment lists and the checkpoint keys line up with the
reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def paths(tree: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs; a path is the tuple of dict keys and list indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from paths(v, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in paths(tree)]


def map_tree(fn: Callable, tree: Any) -> Any:
    """The tree with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def unflatten_like(tree: Any, new_leaves: list) -> Any:
    """A tree shaped like ``tree`` whose leaves, in :func:`leaves` order,
    are ``new_leaves``."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def key_of(path: tuple) -> str:
    """The '/'-joined key of a path, as the reference's checkpoints name
    a leaf."""
    return "/".join(str(p) for p in path)
