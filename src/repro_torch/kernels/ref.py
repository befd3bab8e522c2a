"""Plain float32 PyTorch versions of the port's kernels (independent, naive
math, the layouts of ``repro.kernels.ref``). The CPU path runs them, and the
card-side checks hold each hand-written kernel against them."""
from __future__ import annotations

import torch

NEG_INF = -1e30


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
