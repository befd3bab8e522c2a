"""Kernel entry points, under the dispatch names of ``repro.kernels.ops``.

A CUDA tensor launches the hand-written kernel; a CPU tensor takes its plain
version. There is no other path and no fallback.

None of the kernels has a backward, as none of the reference's Pallas
kernels has one (``jax.grad`` through them fails). So each entry point
refuses a differentiable call, on either device: a tensor the kernel fills
through its C interface carries no autograd history, and the gradients of
everything before it would silently be lost. Training runs
``attn_impl="xla"``, the plain torch paths.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.add_norm import add_norm
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.moe_grouped import moe_grouped
from repro_torch.kernels.rope import rope


# the model step's kernel wrappers whose ``launches`` a ``forward`` span
# carries the growth of, under these names
_COUNTED = {"norm_launches": add_norm, "rope_launches": rope,
            "moe_launches": moe_grouped}


def launch_counts() -> dict:
    """The launches so far of each wrapper in ``_COUNTED``, by its name."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


def _refuse_grad(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (nor has the reference's Pallas "
            f"kernel): it cannot take inputs that require grad while grad is "
            f"enabled. Train with attn_impl=\"xla\", or call it under "
            f"torch.no_grad().")


def flash_attention_op(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B,H,S,D]; k, v: [B,Hkv,T,D]."""
    _refuse_grad("flash_attention", q, k, v)
    return flash_attention(q, k, v, causal=causal, window=window)


def decode_attention_op(q, k_cache, v_cache, pos, *, window: int = 0):
    """q: [B,H,D]; caches: [B,Hkv,W,D]."""
    _refuse_grad("decode_attention", q, k_cache, v_cache)
    return decode_attention(q, k_cache, v_cache, pos, window=window)


def mamba_scan_op(x, dt, b_mat, c_mat, a, d_vec):
    """x, dt: [B,S,D]; b_mat, c_mat: [B,S,N]; a: [D,N]; d_vec: [D].
    Returns (y [B,S,D], h_final [B,D,N])."""
    _refuse_grad("mamba_scan", x, dt, b_mat, c_mat, a, d_vec)
    return mamba_scan(x, dt, b_mat, c_mat, a, d_vec)


def add_norm_op(x, scale, bias=None, delta=None, *, norm_type: str,
                eps: float):
    """x, delta: [..., d]; scale, bias: [d]. Returns (x + delta, its norm);
    (x, its norm) without a delta."""
    _refuse_grad("add_norm", x, scale, bias, delta)
    return add_norm(x, scale, bias, delta, norm_type=norm_type, eps=eps)


def moe_grouped_op(x, order, offsets, weights, top_k: int, w_in, w_down):
    """x: [T,d]; order, weights: [T*k]; offsets: [E+1]; w_in: [E,d,2,ff];
    w_down: [E,ff,d]. Returns out [T*k, d] (``ref.moe_grouped_ref``)."""
    _refuse_grad("moe_grouped", x, weights, w_in, w_down)
    return moe_grouped(x, order, offsets, weights, top_k, w_in, w_down)


def rope_op(q, k, positions, freqs):
    """q: [B,S,Hq,hd]; k: [B,S,Hkv,hd]; positions: [B,S]; freqs: [hd/2].
    Returns (q, k) rotated, in place on the card."""
    _refuse_grad("rope", q, k)
    return rope(q, k, positions, freqs)
