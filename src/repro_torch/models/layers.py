"""Core layer primitives: norms, RoPE/M-RoPE, GQA attention (chunked
online-softmax prefill + ring-buffer decode), SwiGLU/GELU MLPs.

The port of ``repro.models.layers``. Parameters are plain dicts of tensors
in the reference's layouts. Dtypes follow the reference's promotion rules
step by step (a bf16 tensor times a float32 one is float32; dots that the
reference asks for with ``preferred_element_type=float32`` take float32
operands here), so both packages round at the same places. On one card the
reference's sharding constraints have nothing to do: ``cast_param`` is a
cast to the compute dtype and nothing more.

``cfg.attn_impl`` keeps its meaning: ``"xla"`` runs ``chunked_attention`` /
``ring_decode_attention`` in plain torch, ``"pallas"`` the hand-written
kernels (``flash_attention_op`` / ``decode_attention_op``), which take the
plain versions only for CPU tensors.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import decode_attention_op, flash_attention_op

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# --------------------------------------------------------------------------- #
# initialisation helpers
# --------------------------------------------------------------------------- #

def dense_init(gen: torch.Generator, shape, dtype, fan_in=None):
    """Truncated normal in [-2, 2] standard deviations, scaled by
    1/sqrt(fan_in), drawn on ``gen``'s device."""
    fan_in = fan_in if fan_in is not None else shape[0]
    out = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return out.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def init_stacked(make, n: int):
    """``n`` draws of the parameter dict ``make()`` stacked along a new
    leading axis, in draw order. Each draw is copied into tensors made for
    all ``n`` at the first, and dropped, so that no stacked parameter is
    ever held twice (MoE experts' stacked weights run to tens of GB)."""
    def alloc(tree):
        return {k: alloc(v) if isinstance(v, dict) else
                torch.empty((n, *v.shape), dtype=v.dtype, device=v.device)
                for k, v in tree.items()}

    def fill(dst, tree, i):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i] = v

    out = None
    for i in range(n):
        tree = make()
        if out is None:
            out = alloc(tree)
        fill(out, tree, i)
        del tree
    return out


def unstack(tree, n: int):
    """The ``n`` slices along the leading axis of a stacked dict (the
    parameters, or a cache), as a list of dicts of views (an in-place write
    to one reaches the stack): one ``unbind`` per leaf, whose backward
    stacks the slices' gradients once. Indexing the stack once per slice
    (``v[i]``) would give each slice's backward a full-size zero gradient of
    the whole stack to add into."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for dst, part in zip(out, parts):
            dst[k] = part
    return out


def cast_param(p, compute_dtype):
    return p if p.dtype == compute_dtype else p.to(compute_dtype)


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #

def rmsnorm(x, scale, eps=1e-5):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * scale.float()
    return out.to(dtype)


def layernorm(x, scale, bias, eps=1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(dtype)


def apply_norm(x, params, norm_type, eps):
    if norm_type == "layernorm":
        return layernorm(x, params["scale"], params["bias"], eps)
    return rmsnorm(x, params["scale"], eps)


def init_norm(d, norm_type, dtype, device):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


# --------------------------------------------------------------------------- #
# rotary embeddings
# --------------------------------------------------------------------------- #

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_table(head_dim: int, theta: float, sections: Tuple[int, ...],
                device: torch.device) -> torch.Tensor:
    """The frequencies (or, with ``sections``, each half-dim lane's band)
    as a tensor on ``device``, copied there once: a copy from host memory
    per call would wait for the device every layer."""
    if sections:
        table = np.repeat(np.arange(len(sections)), sections)
    else:
        table = rope_frequencies(head_dim, theta)
    return torch.from_numpy(table).to(device)


def apply_rope(x, positions, theta: float, sections: Tuple[int, ...] = ()):
    """Rotate-half RoPE.

    x: [B, S, H, hd]; positions: [B, S] (standard) or [3, B, S] (M-RoPE with
    ``sections`` splitting the half-dim into temporal/height/width bands).
    """
    b, s, h, hd = x.shape
    half = hd // 2
    freqs = _rope_table(hd, theta, (), x.device)
    if sections:
        if sum(sections) != half:
            raise ValueError(f"M-RoPE sections {sections} must sum to {half}")
        if positions.dim() != 3:
            raise ValueError("M-RoPE requires position triples [3,B,S]")
        # band i of the half-dim rotates with positions[i]
        section_ids = _rope_table(hd, theta, sections, x.device)
        pos_per_band = positions.float()[section_ids]          # [half,B,S]
        angles = pos_per_band.permute(1, 2, 0) * freqs         # [B,S,half]
    else:
        angles = positions.float()[..., None] * freqs          # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #

NEG_INF = -1e30


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      chunk: int = 1024, q_offset=0, kv_len=None):
    """Online-softmax attention streamed over KV chunks.

    q: [B, S, Hq, hd]; k, v: [B, T, Hkv, hd]. Never materialises the full
    [S, T] score matrix. ``q_offset`` gives the absolute position of q[0]
    (prefill continuation / decode). ``kv_len`` masks trailing cache slots.
    GQA expands KV to the query heads up front, as the reference does.
    """
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    c = min(chunk, t)
    n_chunks = (t + c - 1) // c
    kv_len = t if kv_len is None else kv_len

    qh = (q * (hd ** -0.5)).to(q.dtype).float()
    q_pos = q_offset + torch.arange(s, device=q.device)
    m = torch.full((b, hq, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, s, hd), dtype=torch.float32, device=q.device)
    for idx in range(n_chunks):
        # the reference pads the last chunk with zero keys, masked by kv_len
        kc = k[:, idx * c:(idx + 1) * c].float()
        vc = v[:, idx * c:(idx + 1) * c].float()
        n = kc.shape[1]
        if n < c:
            kc = F.pad(kc, (0, 0, 0, 0, 0, c - n))
            vc = F.pad(vc, (0, 0, 0, 0, 0, c - n))
        k_pos = idx * c + torch.arange(c, device=q.device)
        scores = torch.einsum("bshd,bchd->bhsc", qh, kc)
        mask = k_pos[None, :] < kv_len
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        scores = torch.where(mask[None, None], scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhsc,bchd->bhsd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)             # [b, s, hq, hd]


def ring_decode_attention(q, k_cache, v_cache, pos, *, window: int = 0,
                          new_kv=None):
    """Single-token attention against a (possibly ring-buffer) KV cache.

    q: [B, 1, Hq, hd]; caches: [B, Hkv, W, hd] (heads-major); ``pos`` is the
    absolute position of the new token. Cache slot i holds absolute position
    ``pos - ((pos - i) mod W)``.

    With ``new_kv=(k_new, v_new)`` ([B, Hkv, 1, hd]) the caches are the
    PRE-update buffers: the new token's slot is masked out of the cache
    scores and its attention term is added explicitly.
    """
    b, _, hq, hd = q.shape
    hkv, w = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = (q * (hd ** -0.5)).reshape(b, hkv, g, hd)
    slots = torch.arange(w, device=q.device)
    abs_pos = pos - torch.remainder(pos - slots, w)          # [W]
    valid = abs_pos >= 0
    if window:
        valid = valid & (pos - abs_pos < window)
    if new_kv is not None:
        valid = valid & (slots != pos % w)      # stale slot -> self term
    scores = torch.einsum("bngd,bnwd->bngw", qg.float(), k_cache.float())
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    if new_kv is not None:
        k_new, v_new = new_kv
        s_self = torch.einsum("bngd,bnwd->bngw", qg.float(), k_new.float())
        m = torch.maximum(scores.amax(-1, keepdim=True), s_self)
        p = torch.exp(scores - m)
        p_self = torch.exp(s_self - m)
        denom = p.sum(-1, keepdim=True) + p_self
        out = torch.einsum("bngw,bnwd->bngd", p.to(v_cache.dtype).float(),
                           v_cache.float())
        out = out + p_self * v_new[:, :, 0, :][:, :, None].float()
        out = out / denom
        return out.reshape(b, 1, hq, hd).to(q.dtype)
    p = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bngw,bnwd->bngd", p.float(), v_cache.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def init_attention(gen, cfg, dtype):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, (d, cfg.num_heads * hd), dtype),
        "wk": dense_init(gen, (d, cfg.num_kv_heads * hd), dtype),
        "wv": dense_init(gen, (d, cfg.num_kv_heads * hd), dtype),
        "wo": dense_init(gen, (cfg.num_heads * hd, d), dtype,
                         fan_in=cfg.num_heads * hd),
    }


def attention_block(params, x, cfg, positions, *, cache=None, pos=None,
                    cross_kv=None, causal=True,
                    compute_dtype=torch.bfloat16):
    """GQA attention. Three modes:
      - prefill/train: cache=None -> attention over x itself (returns
        (out, (k, v)) so callers can build a cache);
      - decode: cache=(k_cache, v_cache), pos given -> ring decode. The
        ring is updated IN PLACE (the new row written at slot pos % W) and
        returned as the new cache;
      - cross-attention: cross_kv=(k, v) precomputed.
    """
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ cast_param(params["wq"], compute_dtype)).reshape(
        b, s, cfg.num_heads, hd)
    if cross_kv is None:
        k = (x @ cast_param(params["wk"], compute_dtype)).reshape(
            b, s, cfg.num_kv_heads, hd)
        v = (x @ cast_param(params["wv"], compute_dtype)).reshape(
            b, s, cfg.num_kv_heads, hd)
        if positions is not None:
            q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        k, v = cross_kv

    use_pallas = cfg.attn_impl == "pallas"
    new_cache = None
    if cache is not None and cross_kv is None:
        k_cache, v_cache = cache
        w = k_cache.shape[2]
        slot = pos % w
        k_new = k.to(k_cache.dtype).transpose(1, 2)          # [B,Hkv,1,hd]
        v_new = v.to(v_cache.dtype).transpose(1, 2)
        if use_pallas:
            k_cache[:, :, slot:slot + 1] = k_new
            v_cache[:, :, slot:slot + 1] = v_new
            out = decode_attention_op(q[:, 0], k_cache, v_cache, pos,
                                      window=cfg.sliding_window)[:, None]
        else:
            # attention against the PRE-update ring plus the self term, then
            # the ring update for the next step, as the reference orders it
            out = ring_decode_attention(q, k_cache, v_cache, pos,
                                        window=cfg.sliding_window,
                                        new_kv=(k_new, v_new))
            k_cache[:, :, slot:slot + 1] = k_new
            v_cache[:, :, slot:slot + 1] = v_new
        new_cache = (k_cache, v_cache)
    elif cache is not None:  # cross-attention with cached encoder KV
        out = chunked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    else:
        if use_pallas:
            out = flash_attention_op(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=causal, window=cfg.sliding_window).transpose(1, 2)
        else:
            out = chunked_attention(q, k, v, causal=causal,
                                    window=cfg.sliding_window,
                                    chunk=cfg.attn_chunk)
        new_cache = (k, v)
    out = out.reshape(b, s, cfg.num_heads * hd)
    out = out @ cast_param(params["wo"], compute_dtype)
    return out, new_cache


# --------------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------------- #

def init_mlp(gen, d, d_ff, mlp_type, dtype):
    if mlp_type == "swiglu":
        return {
            "w_in": dense_init(gen, (d, 2, d_ff), dtype),   # gate/up fused
            "w_down": dense_init(gen, (d_ff, d), dtype, fan_in=d_ff),
        }
    return {
        "w_up": dense_init(gen, (d, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d), dtype, fan_in=d_ff),
    }


def mlp_block(params, x, mlp_type, compute_dtype=torch.bfloat16):
    if mlp_type == "swiglu":
        wi = cast_param(params["w_in"], compute_dtype)
        gu = torch.einsum("bsd,dxf->bsxf", x, wi)      # [B,S,2,ff] fused
        h = F.silu(gu[..., 0, :]) * gu[..., 1, :]
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ cast_param(params["w_up"], compute_dtype),
                   approximate="tanh")
    return h @ cast_param(params["w_down"], compute_dtype)


# --------------------------------------------------------------------------- #
# embeddings / head
# --------------------------------------------------------------------------- #

def init_embedding(gen, vocab, d, dtype):
    return {"table": dense_init(gen, (vocab, d), dtype, fan_in=d)}


def embed(params, tokens, compute_dtype=torch.bfloat16):
    return cast_param(params["table"], compute_dtype)[tokens]


def unembed(params, x, logical_vocab=0, compute_dtype=torch.bfloat16):
    logits = x @ cast_param(params["table"], compute_dtype).T
    if logical_vocab and logical_vocab < params["table"].shape[0]:
        pad = params["table"].shape[0] - logical_vocab
        mask = torch.cat([
            torch.zeros((logical_vocab,), dtype=logits.dtype,
                        device=logits.device),
            torch.full((pad,), NEG_INF, dtype=logits.dtype,
                       device=logits.device)])
        logits = logits + mask
    return logits
