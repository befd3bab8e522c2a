"""Carry the JAX package's parameters across to the port.

The reference keeps an expert's parameters as a pytree (nested dicts of
arrays); the port's ``HostStore`` and ``RealEngine`` keep a flat
``name -> torch.Tensor`` dict, nested names joined with ``.``, and its
models take the reference's nesting (``nest_params`` rebuilds it). Parity
between the two packages comes from converted weights, never from equal
seeds: ``jax.random`` and ``torch.Generator`` draw different numbers.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _tensor(a: Any) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def flatten_params(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested dict -> a flat one, nested names joined with ``.``; the
    values are kept as they are."""
    out: Dict[str, Any] = {}
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, Mapping):
            out.update(flatten_params(value, prefix=f"{key}."))
        else:
            out[key] = value
    return out


def nest_params(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of ``flatten_params``: a flat dict -> the nesting its
    ``.``-joined names give."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        *path, leaf = key.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def params_from_reference(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A nested dict of numpy arrays -> the port's flat tensor dict, dtypes
    kept (bfloat16 included)."""
    return {k: _tensor(v) for k, v in flatten_params(tree).items()}
