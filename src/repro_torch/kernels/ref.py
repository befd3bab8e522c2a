"""Plain float32 PyTorch versions of the port's kernels (independent, naive
math, the layouts of ``repro.kernels.ref``). The CPU path runs them, and the
card-side checks hold each hand-written kernel against them.

The norms and RoPE are the model's own chains (``models/layers.py`` runs
them for ``attn_impl="xla"``, and RoPE's rotation for M-RoPE), so that a CPU
forward through the kernels' entry points is bit for bit the plain one."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Naive attention. q: [B,H,S,D]; k, v: [B,Hkv,T,D] with T >= S; GQA
    by repetition (query head h reads kv head h // (H // Hkv)). Causality
    is right-aligned: query row i sits at position T - S + i."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), kf) / (d ** 0.5)
    q_pos = torch.arange(s, device=q.device)[:, None] + (t - s)
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= (q_pos - k_pos) < window
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p, vf)
    return out.to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, pos, *, window: int = 0):
    """Single-token GQA attention vs a ring cache.

    q: [B,H,D]; caches: [B,Hkv,W,D]; ``pos`` absolute position of the new
    token (cache slot i holds absolute position pos - ((pos - i) mod W);
    ``torch.remainder`` is the floor-mod this needs). Query head h reads kv
    head h // (H // Hkv). Masked scores are -1e30, not -inf, so a row with
    no valid slot averages v instead of turning into NaN."""
    b, h, d = q.shape
    hkv, w = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    k = k_cache.float().repeat_interleave(g, dim=1)
    v = v_cache.float().repeat_interleave(g, dim=1)
    scores = torch.einsum("bhd,bhwd->bhw", q.float(), k) / (d ** 0.5)
    slots = torch.arange(w, device=q.device)
    abs_pos = pos - torch.remainder(pos - slots, w)
    valid = abs_pos >= 0
    if window:
        valid &= (pos - abs_pos) < window
    scores = scores.masked_fill(~valid, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhw,bhwd->bhd", p, v)
    return out.to(q.dtype)


def mamba_scan_ref(x, dt, b_mat, c_mat, a, d_vec, h0=None):
    """Naive sequential selective scan (Mamba-1), in float32:
    ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t`` and ``y_t = C_t h_t
    + D x_t``.

    x, dt: [B,S,D]; b_mat, c_mat: [B,S,N]; a: [D,N]; d_vec: [D]; ``h0``
    [B,D,N] the state before the first step (zeros without it). Returns
    (y [B,S,D] in x's dtype, h_final [B,D,N] float32)."""
    bsz, s, d = x.shape
    xf, dtf = x.float(), dt.float()
    bf, cf, af = b_mat.float(), c_mat.float(), a.float()
    h = (torch.zeros((bsz, d, b_mat.shape[-1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t, :, None] * af[None])               # [B,D,N]
        dbx = (dtf[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :]
        h = da * h + dbx
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    y = torch.stack(ys, dim=1) + xf * d_vec.float()[None, None]
    return y.to(x.dtype), h


def rmsnorm_ref(x, scale, eps=1e-5):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * scale.float()
    return out.to(dtype)


def layernorm_ref(x, scale, bias, eps=1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(dtype)


def add_norm_ref(x, scale, bias=None, delta=None, *, norm_type: str,
                 eps: float):
    """(s, out): s = x + delta in x's dtype (x itself without ``delta``),
    out its ``norm_type`` ("layernorm" with ``bias``, or "rmsnorm") over
    the last dim."""
    if delta is not None:
        x = x + delta
    if norm_type == "layernorm":
        return x, layernorm_ref(x, scale, bias, eps)
    return x, rmsnorm_ref(x, scale, eps)


def rotate_ref(x, angles):
    """Rotate-half RoPE of x [B,S,H,hd] by float32 angles [B,S,hd/2]."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_angles(positions, freqs):
    """float32 angles [B,S,hd/2] of positions [B,S] at frequencies [hd/2]."""
    return positions.float()[..., None] * freqs


def rope_ref(q, k, positions, freqs):
    """(q, k) rotated: q [B,S,Hq,hd] and k [B,S,Hkv,hd] at positions [B,S]
    by the float32 frequencies freqs [hd/2]."""
    angles = rope_angles(positions, freqs)
    return rotate_ref(q, angles), rotate_ref(k, angles)


def moe_grouped_ref(x, order, offsets, weights, top_k: int, w_in, w_down):
    """The dropless MoE layer's expert products, one plain pair of products
    an expert, in float32 (the kernel's accumulation), h and the result
    each rounded once to x's dtype.

    x: [T, d] tokens; ``order`` [T*k]: the (token, choice) pairs as flat
    indices ``token * top_k + choice``, sorted by the held expert they
    chose, the pairs of experts not held last; ``offsets`` [E+1]: where
    each held expert's rows begin in ``order`` (``offsets[E]`` rows in
    all); ``weights`` [T*k] float32: each pair's routing weight; ``w_in``
    [E, d, 2, ff] (gate, up), ``w_down`` [E, ff, d]. Returns out [T*k, d]
    in x's dtype: for a held pair p = order[r], out[p] = weights[p] *
    (silu(x_t W_gate) * (x_t W_up)) W_down of its expert; zero for the
    pairs of experts not held. The offsets are read on the host."""
    d = x.shape[-1]
    ff = w_in.shape[-1]
    out = torch.zeros((order.shape[0], d), dtype=x.dtype, device=x.device)
    bounds = offsets.tolist()
    for e in range(len(bounds) - 1):
        pairs = order[bounds[e]:bounds[e + 1]]
        if not pairs.numel():
            continue
        xs = x[pairs // top_k].float()
        gu = (xs @ w_in[e].reshape(d, 2 * ff).float()).reshape(-1, 2, ff)
        h = (torch.nn.functional.silu(gu[:, 0]) * gu[:, 1]).to(x.dtype)
        y = (h.float() @ w_down[e].float()) * weights[pairs].float()[:, None]
        out[pairs] = y.to(x.dtype)
    return out
