"""Carry the JAX package's parameters across to the port.

The reference keeps an expert's parameters as a pytree (nested dicts of
arrays); the port keeps a flat ``name -> torch.Tensor`` dict, nested names
joined with ``.``. Parity between the two packages comes from converted
weights, never from equal seeds: ``jax.random`` and ``torch.Generator``
draw different numbers.
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


def params_from_reference(tree: Mapping[str, Any], prefix: str = ""
                          ) -> Dict[str, torch.Tensor]:
    """A nested dict of numpy arrays -> the port's flat tensor dict, dtypes
    kept (bfloat16 included)."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, Mapping):
            out.update(params_from_reference(value, prefix=f"{key}."))
        else:
            out[key] = _tensor(value)
    return out
