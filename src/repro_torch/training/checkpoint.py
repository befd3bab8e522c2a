"""Fault-tolerant checkpointing: atomic commit, retry, async snapshots. The
port of ``repro.training.checkpoint``, on the reference's layout.

Layout: ``<dir>/step_<N>/shard_host0.npz`` + ``manifest.json``; a checkpoint
directory is written under a tmp name and atomically renamed on success, so a
crash mid-write never corrupts the latest checkpoint. ``restore_latest``
scans for the newest committed step — the restart path after a node failure.

The leaves of ``{"params": params, "opt_state": opt_state}`` are stored as
``a0, a1, ...`` in ``jax.tree_util``'s flattening order, each named in the
manifest by its ``keystr`` path, with the reference's dtype names; restore
matches them by position. So either package restores the other's
checkpoints bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.training.tree import leaves, leaves_with_names, tree_map, \
    unflatten_like

# numpy has no bfloat16: such a leaf is stored as its 2-byte patterns, which
# is how ``np.savez`` writes the reference's (ml_dtypes) bfloat16 arrays
_BF16_BITS = np.dtype("V2")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_BITS)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 \
            and arr.dtype.kind == "V":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr)).to(like.dtype)
    return t.to(like.device)


def save_checkpoint(ckpt_dir: str, step: int, params: Any, opt_state: Any,
                    extra: Optional[dict] = None, retries: int = 3) -> str:
    """Atomic, retrying checkpoint write. Returns the committed path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    last_err = None
    for attempt in range(retries):
        try:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp, exist_ok=True)
            payload = {"params": params, "opt_state": opt_state}
            arrays = {}
            manifest = {"step": step, "extra": extra or {}, "leaves": []}
            for name, leaf in leaves_with_names(payload):
                key = f"a{len(arrays)}"
                arrays[key] = _to_numpy(leaf)
                manifest["leaves"].append(
                    {"key": key, "name": name,
                     "dtype": _dtype_name(leaf, arrays[key])})
            np.savez(os.path.join(tmp, "shard_host0.npz"), **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)          # atomic commit
            return final
        except OSError as e:               # pragma: no cover - fault path
            last_err = e
            time.sleep(0.1 * (attempt + 1))
    raise RuntimeError(f"checkpoint save failed after {retries} tries: {last_err}")


def restore_latest(ckpt_dir: str, params_like: Any, opt_like: Any
                   ) -> Optional[Tuple[int, Any, Any, dict]]:
    """Restore the newest committed checkpoint into the given tree
    structures (each leaf takes its ``like`` leaf's dtype and device); None
    if no checkpoint exists."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    if not steps:
        return None
    path = os.path.join(ckpt_dir, steps[-1])
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "shard_host0.npz")) as z:
        arrays = [z[leaf["key"]] for leaf in manifest["leaves"]]
    payload_like = {"params": params_like, "opt_state": opt_like}
    restored = [_to_tensor(a, like)
                for a, like in zip(arrays, leaves(payload_like))]
    payload = unflatten_like(payload_like, restored)
    return (manifest["step"], payload["params"], payload["opt_state"],
            manifest.get("extra", {}))


class AsyncCheckpointer:
    """Snapshot-to-host then write on a background thread; training continues.
    ``wait()`` joins the in-flight write (call before exit / next save)."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None
        self.last_committed: Optional[str] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, params: Any, opt_state: Any,
             extra: Optional[dict] = None):
        self.wait()
        # device->host snapshot happens synchronously (consistent view): a
        # copy even of a host tensor, since training updates it in place …
        host = tree_map(lambda t: t.detach().to("cpu", copy=True),
                        (params, opt_state))

        def _write():
            try:
                self.last_committed = save_checkpoint(
                    self.ckpt_dir, step, host[0], host[1], extra)
            except BaseException as e:    # pragma: no cover - fault path
                self._error = e

        # … the (slow) serialization + fsync happens off-thread
        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
