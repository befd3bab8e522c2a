"""Tree -> placements resolution and sizing helpers: the port of
``repro.sharding.partition``. Where the reference builds a
``NamedSharding`` per leaf, the port gives ``(mesh, placements)``, what
``DTensor.from_local`` and ``distribute_tensor`` take."""
from __future__ import annotations

from typing import Any

from repro_torch.sharding.logical import (LogicalRules, placements,
                                          resolve_spec)


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _map(fn, tree, axes):
    """``fn(leaf, axes)`` over the leaves of a tree of dicts and
    NamedTuples (``OptState``), ``axes`` a tree of the same structure whose
    leaves are tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, axes[k]) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map(fn, getattr(tree, f), getattr(axes, f))
                            for f in tree._fields))
    return fn(tree, axes)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def param_shardings(abstract_params: Any, param_axes: Any, mesh,
                    rules: LogicalRules):
    """A tree of ``abstract_params``'s structure whose leaves are ``(mesh,
    placements)``, each leaf's logical axes (the matching leaf of
    ``param_axes``, a tuple of names or ``None`` per dim) resolved against
    its shape."""
    def _one(p, axes):
        return mesh, placements(resolve_spec(p.shape, axes, mesh, rules),
                                mesh)

    return _map(_one, abstract_params, param_axes)


def shape_shardings(abstract_tree: Any, axes_tree: Any, mesh,
                    rules: LogicalRules):
    """Same as param_shardings; the alias used for inputs and caches."""
    return param_shardings(abstract_tree, axes_tree, mesh, rules)


def distribute_tree(tree: Any, shardings: Any):
    """Each tensor leaf of ``tree`` as a DTensor with its ``(mesh,
    placements)`` from ``shardings`` (``param_shardings``'s tree), by
    ``distribute_tensor``: every rank passes the whole tensor and keeps its
    shard."""
    from torch.distributed.tensor import distribute_tensor

    return _map(lambda t, sh: distribute_tensor(t, *sh), tree, shardings)


def tree_size_bytes(tree: Any) -> int:
    """Total bytes of all tensor leaves (meta tensors included; a DTensor
    counts its global shape)."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree)
               if hasattr(t, "shape") and hasattr(t, "dtype"))
