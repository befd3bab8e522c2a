"""Parameter trees of the training path: nested dicts of tensors, and the
``OptState`` NamedTuple over them, walked in ``jax.tree_util``'s order
(dict keys sorted, NamedTuple fields in declaration order, ``None`` an empty
subtree), so that leaf positions and names match the reference's."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves_with_names(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in flattening order; each name is the leaf's path
    as ``jax.tree_util.keystr`` writes it (``['params']['embed']``,
    ``['opt_state'].mu[...]``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in leaves_with_names(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [pair for f in tree._fields
                for pair in leaves_with_names(getattr(tree, f),
                                              f"{prefix}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [pair for i, v in enumerate(tree)
                for pair in leaves_with_names(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_names(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(tree, new_leaves):
    """A tree of ``tree``'s structure holding ``new_leaves`` in flattening
    order."""
    it = iter(new_leaves)

    def take(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: take(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(take(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, (tuple, list)):
            return type(node)(take(v) for v in node)
        return next(it)

    out = take(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
