"""Kernel entry points, under the dispatch names of ``repro.kernels.ops``.

A CUDA tensor launches the hand-written kernel; a CPU tensor takes its plain
version. There is no other path and no fallback.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention


def decode_attention_op(q, k_cache, v_cache, pos, *, window: int = 0):
    """q: [B,H,D]; caches: [B,Hkv,W,D]."""
    return decode_attention(q, k_cache, v_cache, pos, window=window)
