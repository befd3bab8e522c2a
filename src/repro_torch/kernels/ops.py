"""Kernel entry points, under the dispatch names of ``repro.kernels.ops``.

A CUDA tensor launches the hand-written kernel; a CPU tensor takes its plain
version. There is no other path and no fallback.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import mamba_scan


def flash_attention_op(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B,H,S,D]; k, v: [B,Hkv,T,D]."""
    return flash_attention(q, k, v, causal=causal, window=window)


def decode_attention_op(q, k_cache, v_cache, pos, *, window: int = 0):
    """q: [B,H,D]; caches: [B,Hkv,W,D]."""
    return decode_attention(q, k_cache, v_cache, pos, window=window)


def mamba_scan_op(x, dt, b_mat, c_mat, a, d_vec):
    """x, dt: [B,S,D]; b_mat, c_mat: [B,S,N]; a: [D,N]; d_vec: [D].
    Returns (y [B,S,D], h_final [B,D,N])."""
    return mamba_scan(x, dt, b_mat, c_mat, a, d_vec)
