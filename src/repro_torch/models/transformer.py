"""Decoder-only LM stack for the dense, MoE, SSM and hybrid families: the
port of ``repro.models.transformer``.

Parameters keep the reference's nesting (``{"embed", "slots": {"slot{i}":
...}, "final_norm", ["lm_head"]}``), with each period-slot's parameters
stacked along a leading periods axis; where the reference scans over that
axis, the port runs a Python loop. A slot's mixer is attention or mamba and
its FFN an MLP or an MoE layer (``models/moe.py``), so a period may mix them
(jamba's 7 mamba + 1 attention, MoE on odd slots). The encoder-decoder
family is ``models/encdec.py``; this module raises ``NotImplementedError``
for it, as the reference's transformer does not build it either.

Entry points: ``forward`` (full sequence), ``prefill`` (build the cache:
a ring KV cache per attention slot, the (conv, ssm) state per mamba slot,
+ last-token logits), ``decode_step`` (one token against the cache, which
it updates in place).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import init_cache
from repro_torch.obs import tracer as obs_tracer
from repro_torch.sharding.logical import local_region


def check_ported(cfg: ModelConfig) -> None:
    """Raise for an encoder-decoder config: its models are built and run by
    ``models/encdec.py``, not by this decoder-only stack."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder model: build and run it with "
            "repro_torch.models.encdec (models/encdec.py)")


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #

def _init_slot(gen, cfg: ModelConfig, slot, dtype):
    p = {"norm1": L.init_norm(cfg.d_model, cfg.norm_type, dtype, gen.device)}
    if slot.mixer == "attn":
        p["attn"] = L.init_attention(gen, cfg, dtype)
    else:
        p["mamba"] = ssm_lib.init_mamba(gen, cfg, dtype)
    if slot.ffn is not None:
        p["norm2"] = L.init_norm(cfg.d_model, cfg.norm_type, dtype,
                                 gen.device)
        if slot.ffn == "moe":
            p["moe"] = moe_lib.init_moe(gen, cfg, dtype)
        else:
            p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                                  dtype)
    return p


def _slot_axes(cfg: ModelConfig, slot):
    a = {"norm1": dict(L.NORM_AXES) if cfg.norm_type == "layernorm"
         else {"scale": (None,)}}
    if slot.mixer == "attn":
        a["attn"] = dict(L.ATTN_AXES)
    else:
        a["mamba"] = dict(ssm_lib.MAMBA_AXES)
        if cfg.ssm_dt_bc_norms:
            a["mamba"].update(ssm_lib.MAMBA_NORM_AXES)
    if slot.ffn is not None:
        a["norm2"] = dict(a["norm1"])
        if slot.ffn == "moe":
            a["moe"] = dict(moe_lib.MOE_AXES)
        else:
            a["mlp"] = L.mlp_axes(cfg.mlp_type)
    return a


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Parameter dict drawn from ``gen`` on its device; per-slot params
    stacked along a leading periods axis (``layers.init_stacked``: one
    period's draw at a time, never a second copy of a stacked tensor)."""
    check_ported(cfg)
    dtype = L.torch_dtype(cfg.param_dtype)
    n = cfg.num_periods()
    params = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
        "slots": {f"slot{i}": L.init_stacked(
                      lambda s=s: _init_slot(gen, cfg, s, dtype), n)
                  for i, s in enumerate(cfg.block_pattern())},
        "final_norm": L.init_norm(cfg.d_model, cfg.norm_type, dtype,
                                  gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_embedding(gen, cfg.vocab_size,
                                             cfg.d_model, dtype)
    return params


def abstract_params(cfg: ModelConfig):
    """The parameter tree on the meta device: the reference's
    ``jax.eval_shape`` of ``init_params``, shapes and dtypes, nothing
    allocated or drawn (the dry run's stand-in)."""
    return init_params(L.MetaGenerator(), cfg)


def param_axes(cfg: ModelConfig):
    """The parameters' logical axes, a tree of tuples matching
    ``init_params``'s (stacked slot leaves gain a leading "layers")."""
    def layered(axes):
        return {k: layered(v) if isinstance(v, dict) else ("layers",) + v
                for k, v in axes.items()}

    axes = {
        "embed": dict(L.EMBED_AXES),
        "slots": {f"slot{i}": layered(_slot_axes(cfg, s))
                  for i, s in enumerate(cfg.block_pattern())},
        "final_norm": {"scale": (None,)} if cfg.norm_type == "rmsnorm"
        else dict(L.NORM_AXES),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = dict(L.EMBED_AXES)
    return axes


# --------------------------------------------------------------------------- #
# block application
# --------------------------------------------------------------------------- #

def _apply_slot(slot_params, x, cfg: ModelConfig, slot, positions, cdtype,
                cache=None, pos=None):
    """One layer: pre-norm mixer (attention or mamba) + residual, then
    pre-norm FFN (MLP or MoE) + residual. Returns (x, new_cache, aux): an
    attention slot's (k, v) (of this segment without ``cache``; the ring,
    updated in place, with it), a mamba slot's new {"conv", "ssm"} state;
    the MoE layer's auxiliary loss, or None without one."""
    impl = cfg.attn_impl
    h = L.apply_norm(x, slot_params["norm1"], cfg.norm_type, cfg.norm_eps,
                     impl)
    if slot.mixer == "attn":
        kv = None if cache is None else (cache["k"], cache["v"])
        out, new_cache = L.attention_block(slot_params["attn"], h, cfg,
                                           positions, cache=kv, pos=pos,
                                           compute_dtype=cdtype)
    else:
        out, new_cache = ssm_lib.mamba_forward(slot_params["mamba"], h, cfg,
                                               cdtype, state=cache)
    if slot.ffn is None:
        return x + out, new_cache, None
    x, h2 = L.add_apply_norm(x, out, slot_params["norm2"], cfg.norm_type,
                             cfg.norm_eps, impl)
    aux = None
    if slot.ffn == "moe":
        out2, aux, _ = moe_lib.moe_block(slot_params["moe"], h2, cfg, cdtype)
    else:
        out2 = L.mlp_block(slot_params["mlp"], h2, cfg.mlp_type, cdtype)
    return x + out2, new_cache, aux


def _default_positions(cfg: ModelConfig, batch, seq, device, offset=0):
    pos = offset + torch.arange(seq, device=device)[None, :]
    pos = pos.expand(batch, seq)
    if cfg.mrope_sections:
        return pos[None].expand(3, batch, seq)
    return pos


def _embed_input(params, tokens, input_embeds, cdtype):
    if input_embeds is not None:
        return input_embeds.to(cdtype)
    return L.embed(params["embed"], tokens.long(), cdtype)


def _head(params, x, cfg: ModelConfig, cdtype, **axes):
    x = L.apply_norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps,
                     cfg.attn_impl)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return L.unembed(head, x, cfg.logical_vocab_size, cdtype, **axes)


# --------------------------------------------------------------------------- #
# forward (full sequence)
# --------------------------------------------------------------------------- #

def forward(params, tokens, cfg: ModelConfig, positions=None,
            input_embeds=None, mode: str = "eval"):
    """Full-sequence forward. Returns (logits [B,S,V], aux_loss): the sum
    of the MoE layers' auxiliary losses, a float32 zero without them.
    Under rules and a mesh, ``mode="train"`` leaves the logits split over
    the vocabulary for the loss (``layers.TRAIN_LOGITS_AXES``).

    With ``cfg.remat``, ``mode="train"`` and grad enabled, each period is
    rematerialised (``torch.utils.checkpoint``, non-reentrant), as the
    reference checkpoints its period body: the backward keeps only each
    period's input and recomputes the rest. The stacked parameters are
    unbound once per call (``layers.unstack``).

    Inside a real engine's traced ``apply`` (``obs.tracer.active()`` on the
    wall clock), the call records a ``forward`` span from entry to return
    and, on a card, a CUDA event pair around its launches on the current
    stream (the span's ``device_us``, read after a later synchronisation),
    and ``norm_launches`` / ``rope_launches`` / ``moe_launches``: how many
    launches of the norm, RoPE and grouped MoE kernels the call made
    (``ops.launch_counts``). A model with dropless MoE layers adds
    ``moe_rows`` (rows its held experts computed) and ``moe_away`` (choices
    of experts it does not hold); on a card the two counts are copied to
    host memory behind the launches and read with ``device_us``."""
    tracer = obs_tracer.active()
    if not tracer.wall:
        return _forward(params, tokens, cfg, positions, input_embeds, mode)
    lead = tokens if tokens is not None else input_embeds
    with tracer.span("host", "model", "forward",
                     tokens=int(lead.shape[0] * lead.shape[1])) as span:
        timed = lead.is_cuda
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        before = ops.launch_counts()
        tally = [] if cfg.moe_dropless else None
        with moe_lib.tallied(tally):
            out = _forward(params, tokens, cfg, positions, input_embeds,
                           mode)
        span.attrs.update({k: n - before[k]
                           for k, n in ops.launch_counts().items()})
        counts = {}
        if tally:
            rows_away = torch.stack(tally).sum(dim=0)
            if timed:
                host = torch.empty(2, dtype=torch.int64, pin_memory=True)
                host.copy_(rows_away, non_blocking=True)
                counts = {"moe_rows": host[0], "moe_away": host[1]}
            else:
                rows, away = rows_away.tolist()
                span.attrs.update(moe_rows=rows, moe_away=away)
        if timed:
            end.record()
            tracer.defer(span, start, end, counts)
    return out


def _forward(params, tokens, cfg, positions, input_embeds, mode):
    check_ported(cfg)
    cdtype = L.torch_dtype(cfg.compute_dtype)
    x = _embed_input(params, tokens, input_embeds, cdtype)
    b, s = x.shape[:2]
    if positions is None:
        positions = _default_positions(cfg, b, s, x.device)
    pattern = cfg.block_pattern()

    def period_body(sliced, x, aux):
        for i, slot in enumerate(pattern):
            x, _, a = _apply_slot(sliced[f"slot{i}"], x, cfg, slot,
                                  positions, cdtype)
            if a is not None:
                aux = aux + a
        return x, aux

    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for sliced in L.unstack(params["slots"], cfg.num_periods()):
        if remat:
            x, aux = checkpoint(period_body, sliced, x, aux,
                                use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = period_body(sliced, x, aux)
    if mode == "train":         # the loss's layout: split over the vocabulary
        return _head(params, x, cfg, cdtype, axes=L.TRAIN_LOGITS_AXES), aux
    return _head(params, x, cfg, cdtype), aux


# --------------------------------------------------------------------------- #
# prefill
# --------------------------------------------------------------------------- #

def to_ring(kv_seg, width: int):
    """Place a [B,S,Hkv,hd] KV segment into a heads-major [B,Hkv,W,hd] ring:
    position j sits at slot j % W, so with S >= W the last W positions are
    kept, rolled by S % W. Under a mesh on each rank's (batch, heads), the
    sequence whole."""
    def ring(kv_seg):
        s = kv_seg.shape[1]
        k = kv_seg.transpose(1, 2)                    # [B,Hkv,S,hd]
        if s >= width:
            return (torch.roll(k[:, :, s - width:], s % width, dims=2),)
        return (torch.nn.functional.pad(k, (0, 0, 0, width - s)),)

    return local_region(ring, (kv_seg,), (("batch", None, "kv_heads", None),),
                        (("batch", "kv_heads", None, None),))[0]


def prefill(params, tokens, cfg: ModelConfig, cache_width: int,
            positions=None, input_embeds=None):
    """Run the prompt, build a ring KV cache of ``cache_width`` slots for
    each attention slot and the final (conv, ssm) state of each mamba slot
    (conv in the kv dtype, ssm float32). Returns (last-token logits [B,V],
    cache)."""
    check_ported(cfg)
    cdtype = L.torch_dtype(cfg.compute_dtype)
    x = _embed_input(params, tokens, input_embeds, cdtype)
    b, s = x.shape[:2]
    if positions is None:
        positions = _default_positions(cfg, b, s, x.device)
    pattern = cfg.block_pattern()
    cache = init_cache(cfg, b, cache_width, device=x.device)
    for p, sliced in enumerate(L.unstack(params["slots"],
                                         cfg.num_periods())):
        for i, slot in enumerate(pattern):
            x, new_cache, _ = _apply_slot(sliced[f"slot{i}"], x, cfg, slot,
                                          positions, cdtype)
            entry = cache[f"slot{i}"]
            if slot.mixer == "attn":
                k, v = new_cache
                entry["k"][p] = to_ring(k, cache_width)
                entry["v"][p] = to_ring(v, cache_width)
            else:
                entry["conv"][p] = new_cache["conv"]   # cast to the kv dtype
                entry["ssm"][p] = new_cache["ssm"]
    logits = _head(params, x[:, -1:], cfg, cdtype)[:, 0]
    return logits, cache


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #

def decode_step(params, token, pos: int, cache, cfg: ModelConfig,
                positions=None):
    """One decode step. token: [B,1]; pos: absolute position (int). The
    cache is updated IN PLACE (an attention layer's row at slot pos % W, a
    mamba layer's conv and ssm state) and returned. Returns (logits [B,V],
    cache)."""
    check_ported(cfg)
    cdtype = L.torch_dtype(cfg.compute_dtype)
    x = _embed_input(params, token, None, cdtype)
    b = x.shape[0]
    if positions is None:
        positions = _default_positions(cfg, b, 1, x.device, offset=pos)
    pattern = cfg.block_pattern()
    n = cfg.num_periods()
    rings = {name: L.unstack(entry, n) for name, entry in cache.items()}
    for p, sliced in enumerate(L.unstack(params["slots"], n)):
        for i, slot in enumerate(pattern):
            entry = cache[f"slot{i}"]
            x, new_cache, _ = _apply_slot(sliced[f"slot{i}"], x, cfg, slot,
                                          positions, cdtype,
                                          cache=rings[f"slot{i}"][p],
                                          pos=pos)
            if slot.mixer == "mamba":
                entry["conv"][p] = new_cache["conv"]
                entry["ssm"][p] = new_cache["ssm"]
    logits = _head(params, x, cfg, cdtype)[:, 0]
    return logits, cache
