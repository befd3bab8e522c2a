"""Core layer primitives: norms, RoPE/M-RoPE, GQA attention (chunked
online-softmax prefill + ring-buffer decode), SwiGLU/GELU MLPs.

The port of ``repro.models.layers``. Parameters are plain dicts of tensors
in the reference's layouts. Dtypes follow the reference's promotion rules
step by step (a bf16 tensor times a float32 one is float32; dots that the
reference asks for with ``preferred_element_type=float32`` take float32
operands here), so both packages round at the same places. On one card the
reference's sharding hints (``logical_constraint`` and ``cast_param``'s
axes, at the reference's call sites) act only on DTensors under active
rules and a mesh (``repro_torch.sharding``): on one card each is a no-op.

``cfg.attn_impl`` keeps its meaning: ``"xla"`` runs ``chunked_attention`` /
``ring_decode_attention`` in plain torch, ``"pallas"`` the hand-written
kernels (``flash_attention_op`` / ``decode_attention_op``), which take the
plain versions only for CPU tensors. Under ``"pallas"`` the norms (with the
residual add before them, ``add_apply_norm``) and standard RoPE of q and k
(``apply_rope_qk``) are one launch each of hand-written kernels too
(``add_norm_op``, ``rope_op``), which refuse grad as the attention kernels
do; M-RoPE keeps the plain chain.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import (add_norm_op, decode_attention_op,
                                     flash_attention_op, rope_op)
from repro_torch.kernels.ref import (add_norm_ref, layernorm_ref,
                                     rmsnorm_ref, rope_angles, rotate_ref)
from repro_torch.sharding.logical import (gather_leading, local_offset,
                                          local_region, logical_constraint,
                                          logical_reshape)

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


class MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: the init functions, which
    allocate on their generator's device and draw from it, then build a
    tree of meta tensors (shapes and dtypes, no storage, nothing drawn)."""
    device = torch.device("meta")


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


def cast_param(p, compute_dtype, *axes):
    """Cast a (possibly float32, FSDP-sharded) parameter to the compute
    dtype, then constrain the cast to the parameter's logical ``axes``.
    The reference pins the convert to the parameter's sharding with an
    optimization barrier so that XLA's FSDP all-gather moves bf16, not
    float32; torch needs no counterpart: a DTensor's dtype cast is local to
    each shard, so a gather after it moves the compute dtype."""
    if p.dtype == compute_dtype:
        return p
    out = p.to(compute_dtype)
    if axes:
        out = logical_constraint(out, *axes)
    return out


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #

# the plain chains live beside the kernels (``kernels/ref.py``), whose
# entry points take them for CPU tensors
rmsnorm = rmsnorm_ref
layernorm = layernorm_ref


def apply_norm(x, params, norm_type, eps, impl: str = "xla"):
    return add_apply_norm(x, None, params, norm_type, eps, impl)[1]


def add_apply_norm(x, delta, params, norm_type, eps, impl: str = "xla"):
    """(x + delta, its norm): the residual add and the pre-norm after it
    (``delta`` None: (x, its norm)). ``impl="pallas"`` takes them in one
    launch of the hand-written kernel (``add_norm_op``); ``"xla"`` runs the
    plain chain."""
    bias = params["bias"] if norm_type == "layernorm" else None
    run = add_norm_op if impl == "pallas" else add_norm_ref
    return run(x, params["scale"], bias, delta, norm_type=norm_type,
               eps=eps)


NORM_AXES = {"scale": (None,), "bias": (None,)}


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
        angles = rope_angles(positions, freqs)                 # [B,S,half]
    return rotate_ref(x, angles)


def apply_rope_qk(q, k, positions, theta: float,
                  sections: Tuple[int, ...] = (), impl: str = "xla"):
    """(q, k) through ``apply_rope``. ``impl="pallas"`` rotates both in one
    launch of the hand-written kernel, in place on the card (``rope_op``);
    ``"xla"`` and M-RoPE run the plain chain."""
    if impl != "pallas" or sections:
        return (apply_rope(q, positions, theta, sections),
                apply_rope(k, positions, theta, sections))
    return rope_op(q, k, positions,
                   _rope_table(q.shape[-1], theta, (), q.device))


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

    Under rules and a mesh, q takes ("batch", "seq_attn", "heads") and K/V
    ("batch", -, "heads") as in the reference, and the stream runs on each
    rank's local shards (``local_region``; its query rows start at the
    shard's offset): every (batch, head, query row) is independent once
    K/V are whole along the sequence. The softmax state (m, l, acc), which
    the reference constrains to those same axes, is local to the region.
    """
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    kv_axes = ("batch", None, "heads", None)
    q_axes = ("batch", "seq_attn", "heads", None)
    k = logical_constraint(k, *kv_axes)
    v = logical_constraint(v, *kv_axes)
    kv_len = t if kv_len is None else kv_len
    qh = logical_constraint((q * (hd ** -0.5)).to(q.dtype), *q_axes)
    row0 = q_offset + local_offset(qh, 1)

    def stream(qh, k, v):
        return (_stream(qh, k, v, causal=causal, window=window, chunk=chunk,
                        row0=row0, kv_len=kv_len),)

    return local_region(stream, (qh, k, v), (q_axes, kv_axes, kv_axes),
                        (q_axes,))[0]


def _stream(qh, k, v, *, causal, window, chunk, row0, kv_len):
    """``chunked_attention``'s loop over KV chunks; qh is the scaled q,
    its first row at absolute position ``row0``."""
    b, s, hq, hd = qh.shape
    t = k.shape[1]
    c = min(chunk, t)
    n_chunks = (t + c - 1) // c
    dtype = qh.dtype
    qh = qh.float()
    q_pos = row0 + torch.arange(s, device=qh.device)
    m = torch.full((b, hq, s), NEG_INF, dtype=torch.float32, device=qh.device)
    l = torch.zeros((b, hq, s), dtype=torch.float32, device=qh.device)
    acc = torch.zeros((b, hq, s, hd), dtype=torch.float32, device=qh.device)
    for idx in range(n_chunks):
        # the reference pads the last chunk with zero keys, masked by kv_len
        kc = k[:, idx * c:(idx + 1) * c].float()
        vc = v[:, idx * c:(idx + 1) * c].float()
        n = kc.shape[1]
        if n < c:
            kc = F.pad(kc, (0, 0, 0, 0, 0, c - n))
            vc = F.pad(vc, (0, 0, 0, 0, 0, c - n))
        k_pos = idx * c + torch.arange(c, device=qh.device)
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
    return out.transpose(1, 2).to(dtype)               # [b, s, hq, hd]


def ring_decode_attention(q, k_cache, v_cache, pos, *, window: int = 0,
                          new_kv=None):
    """Single-token attention against a (possibly ring-buffer) KV cache.

    q: [B, 1, Hq, hd]; caches: [B, Hkv, W, hd] (heads-major); ``pos`` is the
    absolute position of the new token. Cache slot i holds absolute position
    ``pos - ((pos - i) mod W)``.

    With ``new_kv=(k_new, v_new)`` ([B, Hkv, 1, hd]) the caches are the
    PRE-update buffers: the new token's slot is masked out of the cache
    scores and its attention term is added explicitly. Under rules and a
    mesh that path runs on each rank's local shards (``local_region``); a
    ring sharded along its slots ("kv_seq") takes the scores' max over
    the ranks (an all-reduce) before the exponentials and leaves the
    sums and the p.v products partial.
    """
    b, _, hq, hd = q.shape
    hkv, w = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    if new_kv is not None:
        head = ("batch", "kv_heads", None, None)
        ring = ("batch", "kv_heads", "kv_seq", None)
        k_new, v_new = new_kv
        qg = logical_reshape((q * (hd ** -0.5))[:, 0], (b, hkv, g, hd),
                             *head)
        k_cache = logical_constraint(k_cache, *ring)
        w0 = local_offset(k_cache, 2)
        w_dims = [] if not hasattr(k_cache, "placements") else [
            (k_cache.device_mesh, i)
            for i, p in enumerate(k_cache.placements) if p.is_shard(2)]

        def attend(qg, k_cache, v_cache, k_new):
            slots = w0 + torch.arange(k_cache.shape[2], device=qg.device)
            abs_pos = pos - torch.remainder(pos - slots, w)
            valid = abs_pos >= 0
            if window:
                valid = valid & (pos - abs_pos < window)
            valid = valid & (slots != pos % w)  # stale slot -> self term
            scores = torch.einsum("bngd,bnwd->bngw", qg.float(),
                                  k_cache.float())
            scores = torch.where(valid[None, None, None, :], scores,
                                 NEG_INF)
            s_self = torch.einsum("bngd,bnwd->bngw", qg.float(),
                                  k_new.float())
            m = torch.maximum(scores.amax(-1, keepdim=True), s_self)
            for group in w_dims:
                from torch.distributed._functional_collectives import (
                    all_reduce)
                m = all_reduce(m, "max", group)
            p = torch.exp(scores - m)
            return (p.sum(-1, keepdim=True),
                    torch.einsum("bngw,bnwd->bngd",
                                 p.to(v_cache.dtype).float(),
                                 v_cache.float()),
                    torch.exp(s_self - m))

        l, pv, p_self = local_region(
            attend, (qg, k_cache, v_cache, k_new), (head, ring, ring, head),
            (head, head, head), partial=(("kv_seq",), ("kv_seq",), ()))
        denom = l + p_self
        out = pv + p_self * v_new[:, :, 0, :][:, :, None].float()
        out = out / denom
        return out.reshape(b, 1, hq, hd).to(q.dtype)
    qg = (q * (hd ** -0.5)).reshape(b, hkv, g, hd)
    slots = torch.arange(w, device=q.device)
    abs_pos = pos - torch.remainder(pos - slots, w)          # [W]
    valid = abs_pos >= 0
    if window:
        valid = valid & (pos - abs_pos < window)
    scores = torch.einsum("bngd,bnwd->bngw", qg.float(), k_cache.float())
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bngw,bnwd->bngd", p.float(), v_cache.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def _ring_write(cache, new, slot: int) -> None:
    """``cache[:, :, slot] = new[:, :, 0]`` in place. A DTensor ring writes
    on the rank whose local slots hold ``slot`` (its ``new`` placed as the
    ring's batch and heads), the other ranks write nothing."""
    if not hasattr(cache, "placements"):
        cache[:, :, slot:slot + 1] = new
        return
    local = cache.to_local()
    slot -= local_offset(cache, 2)
    if 0 <= slot < local.shape[2]:
        from torch.distributed.tensor import Replicate

        place = tuple(Replicate() if p.is_shard(2) else p
                      for p in cache.placements)
        local[:, :, slot:slot + 1] = new.redistribute(
            cache.device_mesh, place).to_local()


def init_attention(gen, cfg, dtype):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, (d, cfg.num_heads * hd), dtype),
        "wk": dense_init(gen, (d, cfg.num_kv_heads * hd), dtype),
        "wv": dense_init(gen, (d, cfg.num_kv_heads * hd), dtype),
        "wo": dense_init(gen, (cfg.num_heads * hd, d), dtype,
                         fan_in=cfg.num_heads * hd),
    }


ATTN_AXES = {
    "wq": ("embed", "qkv"),
    "wk": ("embed", "qkv"),
    "wv": ("embed", "qkv"),
    "wo": ("qkv", "embed"),
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
    ``cfg.attn_rope`` False leaves q and k unrotated (Jamba's attention
    has no positional encoding).
    """
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    x = gather_leading(x)
    q_axes = ("batch", "seq_attn", "heads", None)
    kv_axes = ("batch", "kv_seq", "kv_heads", None)
    q = logical_reshape(
        x @ cast_param(params["wq"], compute_dtype, *ATTN_AXES["wq"]),
        (b, s, cfg.num_heads, hd), *q_axes)
    if cross_kv is None:
        k = logical_reshape(
            x @ cast_param(params["wk"], compute_dtype, *ATTN_AXES["wk"]),
            (b, s, cfg.num_kv_heads, hd), *kv_axes)
        v = logical_reshape(
            x @ cast_param(params["wv"], compute_dtype, *ATTN_AXES["wv"]),
            (b, s, cfg.num_kv_heads, hd), *kv_axes)
        if positions is not None and cfg.attn_rope:
            q, k = apply_rope_qk(q, k, positions, cfg.rope_theta,
                                 cfg.mrope_sections, cfg.attn_impl)
    else:
        k, v = cross_kv
    q = logical_constraint(q, *q_axes)
    k = logical_constraint(k, *kv_axes)
    v = logical_constraint(v, *kv_axes)

    use_pallas = cfg.attn_impl == "pallas"
    new_cache = None
    if cache is not None and cross_kv is None:
        k_cache, v_cache = cache
        w = k_cache.shape[2]
        slot = pos % w
        k_new = k.to(k_cache.dtype).transpose(1, 2)          # [B,Hkv,1,hd]
        v_new = v.to(v_cache.dtype).transpose(1, 2)
        if use_pallas:
            _ring_write(k_cache, k_new, slot)
            _ring_write(v_cache, v_new, slot)
            out = decode_attention_op(q[:, 0], k_cache, v_cache, pos,
                                      window=cfg.sliding_window)[:, None]
        else:
            # attention against the PRE-update ring plus the self term, then
            # the ring update for the next step, as the reference orders it
            out = ring_decode_attention(q, k_cache, v_cache, pos,
                                        window=cfg.sliding_window,
                                        new_kv=(k_new, v_new))
            _ring_write(k_cache, k_new, slot)
            _ring_write(v_cache, v_new, slot)
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
    # the merge's gradient, from the product below, is split back into
    # heads: constrained to the heads' layout first (a no-op off a mesh)
    out = logical_constraint(out.reshape(b, s, cfg.num_heads * hd),
                             "batch", "seq_attn", "heads")
    out = gather_leading(out, "heads") @ cast_param(
        params["wo"], compute_dtype, *ATTN_AXES["wo"])
    out = logical_constraint(out, "batch", "seq_q", "embed_act")
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


MLP_AXES = {
    "w_in": ("embed", None, "mlp"),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
}


def mlp_axes(mlp_type: str):
    if mlp_type == "swiglu":
        return {k: MLP_AXES[k] for k in ("w_in", "w_down")}
    return {k: MLP_AXES[k] for k in ("w_up", "w_down")}


def mlp_block(params, x, mlp_type, compute_dtype=torch.bfloat16):
    x = gather_leading(x)
    if mlp_type == "swiglu":
        wi = cast_param(params["w_in"], compute_dtype, *MLP_AXES["w_in"])
        # [B,S,2,ff] fused; under a mesh on local shards, as DTensor would
        # merge (2, ff) with ff sharded and could not split it again
        (gu,) = local_region(
            lambda x, wi: (torch.einsum("bsd,dxf->bsxf", x, wi),), (x, wi),
            (("batch", None, None), (None, None, "mlp")),
            (("batch", None, None, "mlp"),))
        h = F.silu(gu[..., 0, :]) * gu[..., 1, :]
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ cast_param(params["w_up"], compute_dtype,
                                  *MLP_AXES["w_up"]), approximate="tanh")
    h = gather_leading(logical_constraint(h, "batch", "seq_attn", "mlp"),
                       "mlp")
    out = h @ cast_param(params["w_down"], compute_dtype, *MLP_AXES["w_down"])
    return logical_constraint(out, "batch", "seq_q", "embed_act")


# --------------------------------------------------------------------------- #
# embeddings / head
# --------------------------------------------------------------------------- #

def init_embedding(gen, vocab, d, dtype):
    return {"table": dense_init(gen, (vocab, d), dtype, fan_in=d)}


EMBED_AXES = {"table": ("vocab", "embed")}


def embed(params, tokens, compute_dtype=torch.bfloat16):
    """The table's rows of ``tokens``; under a mesh a lookup on each rank's
    tokens into the table gathered whole."""
    table = cast_param(params["table"], compute_dtype, *EMBED_AXES["table"])
    (out,) = local_region(lambda table, tokens: (table[tokens],),
                          (table, tokens), ((None, None), ("batch", None)),
                          (("batch", None, None),))
    return logical_constraint(out, "batch", "seq_q", "embed_act")


# a train step's logits, as the head's product leaves them: split over the
# vocabulary, which the loss takes shard by shard (``cross_entropy_loss``)
TRAIN_LOGITS_AXES = ("batch", None, "vocab")


def unembed(params, x, logical_vocab=0, compute_dtype=torch.bfloat16,
            axes=("batch", "seq_q", "vocab")):
    """Logits [..., V], the pad columns past ``logical_vocab`` at
    ``NEG_INF``, placed by ``axes`` (the reference's hint by default;
    ``TRAIN_LOGITS_AXES`` for a loss, so that no rank gathers the whole
    vocabulary for its tokens)."""
    x = gather_leading(x)
    logits = x @ cast_param(params["table"], compute_dtype,
                            *EMBED_AXES["table"]).T
    if logical_vocab and logical_vocab < params["table"].shape[0]:
        pad = params["table"].shape[0] - logical_vocab
        mask = torch.cat([
            torch.zeros((logical_vocab,), dtype=logits.dtype,
                        device=logits.device),
            torch.full((pad,), NEG_INF, dtype=logits.dtype,
                       device=logits.device)])
        logits = logits + mask
    return logical_constraint(logits, *axes)
