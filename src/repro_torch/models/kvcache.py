"""KV-cache / SSM-state construction: the port of ``repro.models.kvcache``.
An attention slot's entry is a heads-major ring, a mamba slot's the
(conv, ssm) state the decode recurrence carries."""
from __future__ import annotations

import torch

from repro_torch.models.layers import torch_dtype
from repro_torch.sharding.logical import logical_new


def slot_cache_shape(cfg, slot, batch: int, width: int, device="cpu"):
    """Zeroed cache entry for one period-slot (leading dim = n_periods):
    for attention {"k", "v"} [P, B, Hkv, W, hd] in the kv dtype; for mamba
    {"conv": [P, B, W_conv-1, di] in the kv dtype, "ssm": [P, B, di, N]
    float32}. Under rules and a mesh each is a DTensor placed by
    ``slot_cache_axes``, each rank making only its shard
    (``sharding.logical_new``)."""
    p = cfg.num_periods()
    kvdt = torch_dtype(cfg.kv_dtype)
    axes = slot_cache_axes(slot)

    def zeros(name, shape, dtype):
        return logical_new(
            lambda s: torch.zeros(s, dtype=dtype, device=device), shape,
            *axes[name])

    if slot.mixer == "attn":
        shape = (p, batch, cfg.num_kv_heads, width, cfg.resolved_head_dim)
        return {"k": zeros("k", shape, kvdt), "v": zeros("v", shape, kvdt)}
    return {
        "conv": zeros("conv", (p, batch, cfg.ssm_conv_width - 1,
                               cfg.d_inner), kvdt),
        "ssm": zeros("ssm", (p, batch, cfg.d_inner, cfg.ssm_state_dim),
                     torch.float32),
    }


def slot_cache_axes(slot):
    """Logical axes of one period-slot's cache entry: heads before the
    ring's slots, so the model axis goes to the KV heads when they divide
    it, else to the sequence."""
    if slot.mixer == "attn":
        kv = ("layers", "batch", "kv_heads", "kv_seq", None)
        return {"k": kv, "v": kv}
    return {
        "conv": ("layers", "batch", None, "ssm_inner"),
        "ssm": ("layers", "batch", "ssm_inner", "ssm_state"),
    }


def init_cache(cfg, batch: int, width: int, device="cpu"):
    """Cache dict: {"slot{i}": per-slot stacked cache}."""
    return {f"slot{i}": slot_cache_shape(cfg, s, batch, width, device)
            for i, s in enumerate(cfg.block_pattern())}


def cache_axes(cfg):
    return {f"slot{i}": slot_cache_axes(s)
            for i, s in enumerate(cfg.block_pattern())}


def cache_width(cfg, seq_len: int) -> int:
    """Ring-buffer width for a target context length (SWA bounds it)."""
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len
