"""Grouped top-k MoE layer (capacity-based, batched-gather dispatch): the
port of ``repro.models.moe``.

Tokens are cut into groups of ``GROUP_SIZE`` (the tail zero-padded to a
whole group; the padded rows are routed like the others, count in the aux
loss and the expert load, and take capacity slots after every real token).
Within a group each (token, choice) takes the next slot of its expert in
token-major order (the reference's one-hot cumsum, computed here as a
rank after a stable sort by expert: a cumsum over the group's t*k choices
runs one long sequential scan per expert on the card); a choice past the
expert's capacity is dropped, as in GShard. Dispatch is a batched gather of the tokens into an
``[groups, experts, capacity, d]`` buffer, the expert FFN two matrix
products batched over experts, and the combine a batched gather back to
token order, weighted by the renormalised router probabilities.

With ``cfg.moe_dropless`` the layer is the port's own (no counterpart in
the reference): no groups, no capacity, nothing dropped, the top-k weights
renormalised only with ``cfg.moe_renormalize``; and with
``cfg.moe_experts_held`` it holds the weights of a run of the router's
experts only (expert parallelism's share of one card), routes over all of
them, and computes its own experts' part of the result: a choice of an
expert it does not hold adds nothing here. The (token, choice) pairs are
sorted by held expert on the device, with each expert's first row as a
device tensor, and the expert products are the grouped kernel
(``kernels/moe_grouped.py``; its plain version, one pair of products an
expert, for the CPU and ``attn_impl="xla"``), so that no count is read on
the host.

The capacity layer's reference computes all of this in plain ``jnp`` (no
Pallas kernel), so the port computes it with torch tensor ops, with no loop
over experts or tokens; the matrix products are ``torch.matmul``. Two points keep the
port's choices equal to the reference's: ``jax.lax.top_k`` puts the lower
index first among equal probabilities (a zero-padded row ties all of
them), which a stable descending sort reproduces and ``torch.topk`` does
not promise; and the slot positions are exact integer cumsums.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import moe_grouped_op
from repro_torch.kernels.ref import moe_grouped_ref
from repro_torch.models.layers import cast_param, dense_init
from repro_torch.sharding.logical import (gather_leading, local_region,
                                          logical_constraint)


def held_experts(cfg) -> int:
    """The experts whose weights this card holds (``cfg.moe_experts_held``,
    all of the router's where 0)."""
    return cfg.moe_experts_held or cfg.moe_num_experts


def init_moe(gen, cfg, dtype):
    """The router over all ``moe_num_experts``; the expert weights of the
    held ones only."""
    d = cfg.d_model
    s = cfg.moe_ep_split
    e = held_experts(cfg) * s                        # virtual experts
    ff = (cfg.moe_d_ff or cfg.d_ff) // s
    return {
        "router": dense_init(gen, (d, cfg.moe_num_experts), dtype),
        # gate/up fused along a pair dim [e, d, 2, ff]
        "w_in": dense_init(gen, (e, d, 2, ff), dtype),
        "w_down": dense_init(gen, (e, ff, d), dtype, fan_in=ff),
    }


MOE_AXES = {
    "router": ("embed", None),
    "w_in": ("experts", "embed", None, "moe_mlp"),
    "w_down": ("experts", "moe_mlp", "embed"),
}

GROUP_SIZE = 4096  # tokens per dispatch group


def expert_capacity(group_size: int, cfg) -> int:
    if group_size <= 64:
        # tiny groups (decode steps, smoke tests): exactly dropless
        return group_size
    # GShard capacity, rounded up to a multiple of 8
    cap = math.ceil(group_size * cfg.moe_top_k / cfg.moe_num_experts
                    * cfg.moe_capacity_factor)
    return max(8, min(group_size, ((cap + 7) // 8) * 8))


def route(params, xg, cfg, compute_dtype):
    """The router on grouped tokens ``xg`` [g, t, d]: (probs [g, t, E]
    float32, top_w [g, t, k] renormalised, top_i [g, t, k] int64), the
    chosen experts in descending probability and, among equal
    probabilities, ascending index (as ``jax.lax.top_k`` orders them)."""
    logits = (xg @ cast_param(params["router"], compute_dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe_top_k
    top_w, top_i = top_w[..., :k], top_i[..., :k]
    if cfg.moe_renormalize:
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_i


def _counts(idx, n: int):
    """How often each of ``n`` values occurs in each row of ``idx`` [g, m]:
    [g, n] int64, by a scatter-add (no reading of the indices on the host,
    as ``torch.bincount`` and ``F.one_hot``'s range check do on a CUDA
    tensor)."""
    out = torch.zeros((idx.shape[0], n), dtype=torch.long, device=idx.device)
    return out.scatter_add_(1, idx, torch.ones_like(idx))


def moe_block(params, x, cfg, compute_dtype=torch.bfloat16):
    """Returns (out [B,S,d], aux_loss float32 scalar, expert_load [E]
    int32). The layer runs inside a profiler span "moe_block", and its
    expert products inside one of their own, "moe_experts", so that a
    trace can tell its kernels from the model's others."""
    with torch.profiler.record_function("moe_block"):
        if cfg.moe_dropless:
            return _dropless_block(params, x, cfg, compute_dtype)
        if cfg.moe_experts_held:
            raise ValueError(f"{cfg.name}: moe_experts_held needs "
                             "moe_dropless")
        return _moe_block(params, x, cfg, compute_dtype)


def _moe_block(params, x, cfg, compute_dtype):
    b, s, d = x.shape
    t = b * s
    e = cfg.moe_num_experts

    gsize = min(GROUP_SIZE, t)
    pad_t = (-t) % gsize
    xf = gather_leading(x).reshape(t, d)
    if pad_t:
        xf = F.pad(xf, (0, 0, 0, pad_t))
    g = (t + pad_t) // gsize
    xg = xf.reshape(g, gsize, d)
    xg = logical_constraint(xg, "moe_groups", "moe_tokens", "embed_act")
    cap = expert_capacity(gsize, cfg)
    e_v = e * cfg.moe_ep_split

    # routing, slots and dispatch are independent for each group: under a
    # mesh they run on each rank's groups (``local_region``), the router's
    # weight gathered whole
    grp, tok = ("moe_groups", None), ("moe_groups", "moe_tokens", None)
    probs, top_w, first_counts, counts, buf_pos, buf = local_region(
        lambda xg, router: _dispatch(xg, router, cfg, cap, compute_dtype),
        (xg, params["router"]),
        (("moe_groups", "moe_tokens", "embed_act"), (None, None)),
        (tok, tok, grp, grp, grp, ("moe_groups", None, "embed_act")))

    # --- load-balancing auxiliary loss (Switch-style): the fraction of
    #     tokens whose first choice is each expert (exact counts) ---
    frac_tokens = first_counts.sum(dim=0).float() / (g * gsize)
    mean_probs = probs.reshape(-1, e).mean(dim=0)
    aux = e * torch.sum(frac_tokens * mean_probs)
    expert_load = counts.sum(dim=0).to(torch.int32)

    buf = logical_constraint(buf.reshape(g, e_v, cap, d), "moe_groups",
                             "experts", None, "embed_act")

    # --- expert FFN, batched over experts in the compute dtype; under a
    #     mesh on each rank's (groups, experts, ff) shard, the down
    #     projection's sum over a sharded ff left partial ---
    with torch.profiler.record_function("moe_experts"):
        wi = cast_param(params["w_in"], compute_dtype,
                        *MOE_AXES["w_in"])                    # [Ev,d,2,f]
        wd = cast_param(params["w_down"], compute_dtype,
                        *MOE_AXES["w_down"])                  # [Ev,f,d]
        (out_buf,) = local_region(
            _experts, (buf, wi, wd),
            (("moe_groups", "experts", None, "embed_act"),
             ("experts", None, None, "moe_mlp"),
             ("experts", "moe_mlp", None)),
            (("moe_groups", "experts", None, "embed_act"),),
            partial=(("moe_mlp",),))
    out_buf = logical_constraint(out_buf, "moe_groups", "experts", None,
                                 "embed_act")
    out_flat = out_buf.reshape(g, e_v * cap, d)

    (yg,) = local_region(
        lambda out_flat, buf_pos, top_w: (_combine(out_flat, buf_pos, top_w,
                                                   cfg, compute_dtype),),
        (out_flat, buf_pos, top_w),
        (("moe_groups", None, "embed_act"), grp, tok),
        (("moe_groups", "moe_tokens", "embed_act"),))
    yg = logical_constraint(yg, "moe_groups", "moe_tokens", "embed_act")

    y = yg.reshape(g * gsize, d)
    if pad_t:
        y = y[:t]
    out = logical_constraint(y.reshape(b, s, d), "batch", "seq_q",
                             "embed_act")
    return out, aux, expert_load


def _dropless_block(params, x, cfg, compute_dtype):
    """The dropless layer over the held experts (experts 0 ..
    ``held_experts(cfg)`` - 1): routing over all ``moe_num_experts``, the
    held pairs sorted by expert, the grouped expert products, the weighted
    sum over each token's choices in token order. Returns what
    ``moe_block`` returns."""
    if cfg.moe_ep_split != 1:
        raise ValueError(f"{cfg.name}: the dropless layer takes no "
                         "moe_ep_split")
    b, s, d = x.shape
    t, k, e = b * s, cfg.moe_top_k, cfg.moe_num_experts
    held = held_experts(cfg)
    xf = x.reshape(t, d)
    probs, top_w, top_i = route(params, xf[None], cfg, compute_dtype)
    flat_e = top_i.reshape(1, t * k)
    counts = _counts(flat_e, e)[0]                            # [E]
    frac_tokens = _counts(top_i[..., 0], e)[0].float() / t
    aux = e * torch.sum(frac_tokens * probs[0].mean(dim=0))
    # each held pair's row: a stable sort by held expert, the pairs of the
    # experts not held last; each held expert's first row
    key = torch.clamp(flat_e[0], max=held)
    order = torch.sort(key, stable=True)[1]
    offsets = F.pad(torch.cumsum(counts[:held], 0), (1, 0))
    with torch.profiler.record_function("moe_experts"):
        run = moe_grouped_op if cfg.attn_impl == "pallas" \
            else moe_grouped_ref
        out = run(xf, order, offsets, top_w.reshape(t * k), k,
                  cast_param(params["w_in"], compute_dtype),
                  cast_param(params["w_down"], compute_dtype))
    tally = getattr(_TALLY, "current", None)
    if tally is not None:
        tally.append(torch.stack([offsets[-1], t * k - offsets[-1]]))
    return out.view(t, k, d).sum(dim=1).view(b, s, d), aux, \
        counts.to(torch.int32)


# --------------------------------------------------------------------------- #
# counters of a traced forward
# --------------------------------------------------------------------------- #

_TALLY = threading.local()


@contextmanager
def tallied(tally):
    """For the length of the block, each dropless MoE layer this thread
    runs appends to the list ``tally`` (None: nothing) a device tensor of
    two counts: the rows its held experts computed and its choices of
    experts not held. Nothing is read on the host here."""
    prev = getattr(_TALLY, "current", None)
    _TALLY.current = tally
    try:
        yield tally
    finally:
        _TALLY.current = prev


def _dispatch(xg, router, cfg, cap: int, compute_dtype):
    """Routing, slots and dispatch of groups ``xg`` [g, t, d]: (probs,
    top_w, each group's counts of first choices [g, E], of all choices
    [g, E], each choice's buffer position [g, t*kk] (``Ev*cap`` where
    dropped), the dispatched buffer [g, Ev*cap, d])."""
    g, gsize, d = xg.shape
    k, e = cfg.moe_top_k, cfg.moe_num_experts
    probs, top_w, top_i = route({"router": router}, xg, cfg, compute_dtype)
    first_counts = _counts(top_i[..., 0], e)

    # --- per-group slot assignment: the position of each (token, choice)
    #     within its expert over the group's flattened (t*k) stream, i.e.
    #     the reference's one-hot cumsum, as a rank: a stable sort by
    #     expert keeps each expert's choices in stream order ---
    flat_e = top_i.reshape(g, gsize * k)
    counts = _counts(flat_e, e)                               # [g, E]
    sorted_e, order = torch.sort(flat_e, dim=1, stable=True)
    first = torch.cumsum(counts, dim=1) - counts   # each expert's first rank
    rank = torch.arange(gsize * k, device=xg.device) - first.gather(
        1, sorted_e)
    slot = torch.empty_like(flat_e).scatter_(1, order, rank)
    in_cap = slot < cap
    token_ids = torch.arange(gsize, device=xg.device).repeat_interleave(k)
    token_ids = token_ids.expand(g, gsize * k)

    # --- virtual-expert expansion: every (token, choice) goes to all sp
    #     slices of its chosen expert, with the same slot ---
    sp = cfg.moe_ep_split
    kk = k * sp
    e_v = e * sp
    if sp > 1:
        flat_e = (flat_e[..., None] * sp
                  + torch.arange(sp, device=xg.device)).reshape(g,
                                                                gsize * kk)
        slot = slot.repeat_interleave(sp, dim=-1)
        in_cap = in_cap.repeat_interleave(sp, dim=-1)
        token_ids = token_ids.repeat_interleave(sp, dim=-1)

    # --- dispatch: token-id table [g, Ev*cap] (empty slots point at a zero
    #     row), then a batched gather ---
    buf_pos = torch.where(in_cap, flat_e * cap + slot, e_v * cap)
    table = torch.full((g, e_v * cap + 1), gsize, dtype=torch.long,
                       device=xg.device)
    table.scatter_(1, buf_pos, token_ids)          # dropped -> last column
    table = table[:, :e_v * cap]
    rows = torch.arange(g, device=xg.device)[:, None]
    xg_pad = F.pad(xg, (0, 0, 0, 1))                          # zero row
    buf = xg_pad[rows, table]                                 # [g, Ev*c, d]
    return probs, top_w, first_counts, counts, buf_pos, buf


def _experts(buf, wi, wd):
    """The expert FFN on the dispatched buffer [g, Ev, cap, d]: SwiGLU's
    fused gate/up product, SiLU x up, the down product; [g, Ev, cap, d]."""
    g, e_v, cap, d = buf.shape
    ff = wi.shape[-1]
    be = buf.transpose(0, 1).reshape(e_v, g * cap, d)
    gu = torch.matmul(be, wi.reshape(e_v, d, 2 * ff)).reshape(
        e_v, g * cap, 2, ff)
    h = F.silu(gu[..., 0, :]) * gu[..., 1, :]
    del gu
    out_e = torch.matmul(h, wd)                               # [Ev,g*c,d]
    return (out_e.reshape(e_v, g, cap, d).transpose(0, 1),)


def _combine(out_flat, buf_pos, top_w, cfg, compute_dtype):
    """Batched gather of the expert outputs [g, Ev*cap, d] back to token
    order, weighted, summed over the k choices (and the sp slices, whose
    partial outputs add): [g, t, d]."""
    g, _, d = out_flat.shape
    gsize = top_w.shape[1]
    sp = cfg.moe_ep_split
    kk = cfg.moe_top_k * sp
    rows = torch.arange(g, device=out_flat.device)[:, None]
    out_pad = F.pad(out_flat, (0, 0, 0, 1))                   # zero row
    gathered = out_pad[rows, buf_pos]                         # [g, t*kk, d]
    w_comb = top_w if sp == 1 else top_w.repeat_interleave(sp, dim=-1)
    gathered = gathered.reshape(g, gsize, kk, d) \
        * w_comb[..., None].to(compute_dtype)
    return gathered.sum(dim=2)                                # [g, t, d]
