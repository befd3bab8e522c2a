"""Whisper-style encoder-decoder backbone: the port of
``repro.models.encdec``.

The conv/audio frontend is the reference's stub: the caller provides
precomputed frame embeddings [B, 1500, d]. Encoder = bidirectional
attention stack; decoder = causal self-attention + cross-attention to the
encoded audio. Sinusoidal positions (no RoPE), LayerNorm + GELU, MHA
(kv == heads). Where the reference scans over the stacked layers, the port
runs a Python loop.

With ``attn_impl="pallas"`` the encoder's self-attention and every
cross-attention run the ``flash_attention`` kernel with ``causal=False``
(the reference's ``attention_block`` takes that branch for both, since the
decoder passes its cross K/V and no cache), the decoder's prefill its
causal self-attention through the same kernel, and each decode step its
self-attention through ``decode_attention`` against a ring.

Entry points: ``encode``, ``cross_kv``, ``decode_train`` (teacher-forced
logits), ``prefill`` (last-token logits and the caches: a self-attention
ring a layer, the cross K/V) and ``decode_step`` (one token; the rings are
updated in place).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import to_ring
from repro_torch.sharding.logical import logical_new


def sinusoidal_positions(length: int, d: int, offset=0, device="cpu"):
    pos = offset + torch.arange(length, device=device)[:, None].float()
    dim = torch.arange(d // 2, device=device)[None, :].float()
    inv = torch.exp(-math.log(10000.0) * dim / max(1, d // 2 - 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #

def _enc_layer(gen, cfg, dtype):
    dev = gen.device
    return {
        "norm1": L.init_norm(cfg.d_model, "layernorm", dtype, dev),
        "attn": L.init_attention(gen, cfg, dtype),
        "norm2": L.init_norm(cfg.d_model, "layernorm", dtype, dev),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, "gelu", dtype),
    }


def _dec_layer(gen, cfg, dtype):
    dev = gen.device
    return {
        "norm1": L.init_norm(cfg.d_model, "layernorm", dtype, dev),
        "attn": L.init_attention(gen, cfg, dtype),
        "norm_x": L.init_norm(cfg.d_model, "layernorm", dtype, dev),
        "xattn": L.init_attention(gen, cfg, dtype),
        "norm2": L.init_norm(cfg.d_model, "layernorm", dtype, dev),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, "gelu", dtype),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Parameter dict drawn from ``gen`` on its device, in the reference's
    nesting; each stack's layers stacked along a leading axis."""
    dtype = L.torch_dtype(cfg.param_dtype)
    dev = gen.device
    return {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
        "encoder": L.init_stacked(lambda: _enc_layer(gen, cfg, dtype),
                                  cfg.encoder_layers),
        "enc_final": L.init_norm(cfg.d_model, "layernorm", dtype, dev),
        "decoder": L.init_stacked(lambda: _dec_layer(gen, cfg, dtype),
                                  cfg.num_layers),
        "dec_final": L.init_norm(cfg.d_model, "layernorm", dtype, dev),
    }


def abstract_params(cfg: ModelConfig):
    """The parameter tree on the meta device (shapes and dtypes only)."""
    return init_params(L.MetaGenerator(), cfg)


def param_axes(cfg: ModelConfig):
    def layered(axes):
        return {k: layered(v) if isinstance(v, dict) else ("layers",) + v
                for k, v in axes.items()}

    enc = layered({"norm1": dict(L.NORM_AXES), "attn": dict(L.ATTN_AXES),
                   "norm2": dict(L.NORM_AXES), "mlp": L.mlp_axes("gelu")})
    dec = layered({"norm1": dict(L.NORM_AXES), "attn": dict(L.ATTN_AXES),
                   "norm_x": dict(L.NORM_AXES), "xattn": dict(L.ATTN_AXES),
                   "norm2": dict(L.NORM_AXES), "mlp": L.mlp_axes("gelu")})
    return {
        "embed": dict(L.EMBED_AXES),
        "encoder": enc,
        "enc_final": dict(L.NORM_AXES),
        "decoder": dec,
        "dec_final": dict(L.NORM_AXES),
    }


# --------------------------------------------------------------------------- #
# encoder
# --------------------------------------------------------------------------- #

def encode(params, audio_embeds, cfg: ModelConfig):
    """audio_embeds: [B, F, d] precomputed frame embeddings (stub
    frontend)."""
    cdtype = L.torch_dtype(cfg.compute_dtype)
    b, f, d = audio_embeds.shape
    x = audio_embeds.to(cdtype) + sinusoidal_positions(
        f, d, device=audio_embeds.device).to(cdtype)
    for lp in L.unstack(params["encoder"], cfg.encoder_layers):
        h = L.apply_norm(x, lp["norm1"], "layernorm", cfg.norm_eps)
        out, _ = L.attention_block(lp["attn"], h, cfg, None, causal=False,
                                   compute_dtype=cdtype)
        x = x + out
        h = L.apply_norm(x, lp["norm2"], "layernorm", cfg.norm_eps)
        x = x + L.mlp_block(lp["mlp"], h, "gelu", cdtype)
    return L.apply_norm(x, params["enc_final"], "layernorm", cfg.norm_eps)


def _layer_kv(xattn, enc_out, cfg: ModelConfig, cdtype):
    """One decoder layer's cross-attention (k, v) [B, F, H, hd]."""
    b, f, _ = enc_out.shape
    shape = (b, f, cfg.num_kv_heads, cfg.resolved_head_dim)
    return tuple((enc_out @ L.cast_param(xattn[f"w{n}"], cdtype)
                  ).reshape(shape) for n in ("k", "v"))


def cross_kv(params, enc_out, cfg: ModelConfig):
    """Per-decoder-layer cross-attention K/V: {"k", "v"} [L, B, F, H, hd]."""
    cdtype = L.torch_dtype(cfg.compute_dtype)
    b, f, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, b, f, cfg.num_kv_heads, hd)
    kv = {n: logical_new(lambda s: torch.empty(s, dtype=enc_out.dtype,
                                               device=enc_out.device),
                         shape, *CROSS_AXES)
          for n in ("k", "v")}
    for i, lp in enumerate(L.unstack(params["decoder"], cfg.num_layers)):
        kv["k"][i], kv["v"][i] = _layer_kv(lp["xattn"], enc_out, cfg,
                                           cdtype)
    return kv


# --------------------------------------------------------------------------- #
# decoder
# --------------------------------------------------------------------------- #

def _dec_block(lp, x, cfg, cdtype, self_cache=None, pos=None, xkv=None):
    h = L.apply_norm(x, lp["norm1"], "layernorm", cfg.norm_eps)
    out, new_kv = L.attention_block(lp["attn"], h, cfg, None,
                                    cache=self_cache, pos=pos,
                                    compute_dtype=cdtype)
    x = x + out
    h = L.apply_norm(x, lp["norm_x"], "layernorm", cfg.norm_eps)
    out, _ = L.attention_block(lp["xattn"], h, cfg, None,
                               cross_kv=(xkv["k"], xkv["v"]),
                               causal=False, compute_dtype=cdtype)
    x = x + out
    h = L.apply_norm(x, lp["norm2"], "layernorm", cfg.norm_eps)
    x = x + L.mlp_block(lp["mlp"], h, "gelu", cdtype)
    return x, new_kv


def _embed_tokens(params, tokens, cfg, cdtype, offset=0):
    x = L.embed(params["embed"], tokens.long(), cdtype)
    return x + sinusoidal_positions(tokens.shape[1], cfg.d_model, offset,
                                    device=x.device).to(cdtype)


def _logits(params, x, cfg, cdtype, **axes):
    x = L.apply_norm(x, params["dec_final"], "layernorm", cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg.logical_vocab_size, cdtype,
                     **axes)


def decode_train(params, tokens, audio_embeds, cfg: ModelConfig):
    """Teacher-forced decoder over the full token sequence. Returns
    logits [B, S, V], under a mesh split over the vocabulary for the loss.

    Each layer's cross K/V is computed from the encoder's output before the
    decoder runs, as the reference's ``cross_kv`` does, but kept per layer
    rather than stacked. With ``cfg.remat`` and grad enabled each decoder
    layer is rematerialised (``torch.utils.checkpoint``, non-reentrant), as
    the reference checkpoints its decoder body."""
    cdtype = L.torch_dtype(cfg.compute_dtype)
    enc_out = encode(params, audio_embeds, cfg)
    layers = L.unstack(params["decoder"], cfg.num_layers)
    xkv = [_layer_kv(lp["xattn"], enc_out, cfg, cdtype) for lp in layers]
    x = _embed_tokens(params, tokens, cfg, cdtype)

    def body(lp, x, k, v):
        return _dec_block(lp, x, cfg, cdtype, xkv={"k": k, "v": v})[0]

    remat = cfg.remat and torch.is_grad_enabled()
    for lp, (k, v) in zip(layers, xkv):
        if remat:
            x = checkpoint(body, lp, x, k, v, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = body(lp, x, k, v)
    return _logits(params, x, cfg, cdtype, axes=L.TRAIN_LOGITS_AXES)


def prefill(params, tokens, audio_embeds, cfg: ModelConfig, cache_width: int):
    """Returns (last-token logits [B, V], {"self": ring KV {"k", "v"}
    [L, B, Hkv, W, hd] in the kv dtype, "cross": the cross K/V})."""
    cdtype = L.torch_dtype(cfg.compute_dtype)
    enc_out = encode(params, audio_embeds, cfg)
    xkv = cross_kv(params, enc_out, cfg)
    x = _embed_tokens(params, tokens, cfg, cdtype)
    self_cache = init_self_cache(cfg, tokens.shape[0], cache_width,
                                 device=x.device)
    layers = zip(L.unstack(params["decoder"], cfg.num_layers),
                 L.unstack(xkv, cfg.num_layers))
    for i, (lp, kv) in enumerate(layers):
        x, (k, v) = _dec_block(lp, x, cfg, cdtype, xkv=kv)
        self_cache["k"][i] = to_ring(k, cache_width)   # cast to the kv dtype
        self_cache["v"][i] = to_ring(v, cache_width)
    logits = _logits(params, x[:, -1:], cfg, cdtype)[:, 0]
    return logits, {"self": self_cache, "cross": xkv}


def decode_step(params, token, pos: int, cache, cfg: ModelConfig):
    """One decoder token against the self-attention rings and the cross
    K/V. token: [B, 1]; pos: its absolute position. The rings are updated
    IN PLACE (slot pos % W) and the cache returned. Returns (logits [B, V],
    cache)."""
    cdtype = L.torch_dtype(cfg.compute_dtype)
    x = _embed_tokens(params, token, cfg, cdtype, offset=pos)
    n = cfg.num_layers
    for lp, ring, kv in zip(L.unstack(params["decoder"], n),
                            L.unstack(cache["self"], n),
                            L.unstack(cache["cross"], n)):
        x, _ = _dec_block(lp, x, cfg, cdtype,
                          self_cache=(ring["k"], ring["v"]), pos=pos,
                          xkv=kv)
    logits = _logits(params, x, cfg, cdtype)[:, 0]
    return logits, cache


# the caches' logical axes: the self-attention rings heads-major
# [L, B, Hkv, W, hd], the cross K/V in the [L, B, F, H, hd] layout the
# attention consumes
SELF_AXES = ("layers", "batch", "kv_heads", "kv_seq", None)
CROSS_AXES = ("layers", "batch", "kv_seq", "kv_heads", None)


def init_self_cache(cfg: ModelConfig, batch: int, width: int, device="cpu"):
    """The zeroed self-attention rings; under rules and a mesh DTensors
    placed by ``SELF_AXES``, each rank making only its shard."""
    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, width, hd)
    kvdt = L.torch_dtype(cfg.kv_dtype)
    return {n: logical_new(
                lambda s: torch.zeros(s, dtype=kvdt, device=device), shape,
                *SELF_AXES) for n in ("k", "v")}
