"""A pytree walk in the JAX package's flatten order.

The port's parameter and state records are the JAX package's pytree
forms: NamedTuples, tuples and lists of tensors (an mlp is a list of
``(w, b)`` pairs, a ``TransformerParams`` holds a tuple of
``BlockParams``). The walk visits a NamedTuple's fields in order, a tuple's
or a list's items in order, and drops ``None``; anything else (a tensor, a
Python scalar such as ``TreeEnsemble.max_depth``) is a leaf. That is
``jax.tree_util.tree_leaves``'s order, so checkpoints and artifacts name
the leaves as the JAX package does, and :func:`keystr` paths are
``jax.tree_util.keystr``'s (``.blocks[1].wq``, ``[0][1]``).
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, List, Tuple

import torch


def _children(tree):
    """``[(key, child)]`` of an inner node, or None for a leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{n}", getattr(tree, n)) for n in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    return None


def _make(tree, children: list):
    """A node of ``tree``'s type holding ``children``."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*children)
    return type(tree)(children)


def leaves_with_path(tree, path: str = "") -> List[Tuple[str, object]]:
    """``(keystr path, leaf)`` pairs in flatten order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for key, child in kids:
        out += leaves_with_path(child, path + key)
    return out


def leaves(tree) -> list:
    """The leaves in flatten order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def keystr(tree) -> List[str]:
    """The leaves' ``jax.tree_util.keystr`` paths, in flatten order."""
    return [path for path, _ in leaves_with_path(tree)]


_END = object()


def _rebuild(tree, values: Iterator):
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return next(values)
    return _make(tree, [_rebuild(c, values) for _, c in kids])


def unflatten(tree, values: Iterable):
    """``tree``'s structure with its leaves replaced, in flatten order,
    by ``values`` (``None`` stays ``None``)."""
    it = iter(values)
    out = _rebuild(tree, it)
    if next(it, _END) is not _END:
        raise ValueError("more values than the tree has leaves")
    return out


def map(fn: Callable, tree, *rest):  # noqa: A001 — jax.tree.map's name
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different structures")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def structure(tree):
    """A hashable description of ``tree``'s structure: the node types and
    the leaves' positions (two trees with equal structures flatten to
    leaves that pair up)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return "*"
    return (type(tree), tuple(structure(c) for _, c in kids))


def to(tree, device):
    """``tree`` with every tensor leaf on ``device`` (other leaves kept)."""
    return map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t,
               tree)


def clone(tree):
    """A copy of ``tree`` whose tensors share no storage with it."""
    return map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
               tree)
