"""KV-cache construction: the port of ``repro.models.kvcache`` for the
attention slots (a mamba slot's state comes with the SSM slice)."""
from __future__ import annotations

import torch

from repro_torch.models.layers import torch_dtype

SSM_ITEM = "ROADMAP Queue 1 item 2 (the SSM slice, mamba_scan)"


def slot_cache_shape(cfg, slot, batch: int, width: int, device="cpu"):
    """Zeroed cache entry for one period-slot (leading dim = n_periods), in
    the heads-major layout [P, B, Hkv, W, hd]."""
    if slot.mixer != "attn":
        raise NotImplementedError(
            f"{cfg.name}: a {slot.mixer} slot's cache is not ported yet; "
            f"see {SSM_ITEM}")
    shape = (cfg.num_periods(), batch, cfg.num_kv_heads, width,
             cfg.resolved_head_dim)
    kvdt = torch_dtype(cfg.kv_dtype)
    return {"k": torch.zeros(shape, dtype=kvdt, device=device),
            "v": torch.zeros(shape, dtype=kvdt, device=device)}


def init_cache(cfg, batch: int, width: int, device="cpu"):
    """Cache dict: {"slot{i}": per-slot stacked cache}."""
    return {f"slot{i}": slot_cache_shape(cfg, s, batch, width, device)
            for i, s in enumerate(cfg.block_pattern())}


def cache_width(cfg, seq_len: int) -> int:
    """Ring-buffer width for a target context length (SWA bounds it)."""
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len
