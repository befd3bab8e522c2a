"""Plain float32 reference of a StarCoder2 expert (bigcode/starcoder2-3b,
arXiv:2402.19173): pre-LayerNorm decoder layers of GQA self-attention with
rotate-half RoPE (the configuration's theta) and a GELU (tanh) MLP, a final
LayerNorm and a head tied to the embedding.

It reads its sizes from the configuration file's published keys and its
weights from the flat parameter names that ``layout`` lists (the port's
layout, which the benchmark's weight maker fills). No kernel, no cache, no
batching across rows: every row's logits depend on that row alone. Linear
layers carry no bias, as the served program's do not (see the configuration
file's ``not_run``); ``sliding_window`` is applied as published.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def sizes(cfg: dict) -> dict:
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    return {"d": d, "h": h, "hkv": cfg["num_key_value_heads"], "hd": d // h,
            "ff": cfg["intermediate_size"], "v": cfg["vocab_size"],
            "layers": cfg["num_hidden_layers"]}


def layout(cfg: dict):
    """(flat name, shape, dtype, init, fan-in) of every weight, the layers
    stacked along a leading axis; ``cfg["served_dtype"]`` is the served
    dtype."""
    z = sizes(cfg)
    d, h, hkv, hd, ff, v, n = (z["d"], z["h"], z["hkv"], z["hd"], z["ff"],
                               z["v"], z["layers"])
    w = cfg["served_dtype"]
    s = "slots.slot0."
    return [
        ("embed.table", (v, d), w, "dense", d),
        (s + "norm1.scale", (n, d), w, "norm_scale", 0),
        (s + "norm1.bias", (n, d), w, "norm_bias", 0),
        (s + "attn.wq", (n, d, h * hd), w, "dense", d),
        (s + "attn.wk", (n, d, hkv * hd), w, "dense", d),
        (s + "attn.wv", (n, d, hkv * hd), w, "dense", d),
        (s + "attn.wo", (n, h * hd, d), w, "dense", h * hd),
        (s + "norm2.scale", (n, d), w, "norm_scale", 0),
        (s + "norm2.bias", (n, d), w, "norm_bias", 0),
        (s + "mlp.w_up", (n, d, ff), w, "dense", d),
        (s + "mlp.w_down", (n, ff, d), w, "dense", ff),
        ("final_norm.scale", (d,), w, "norm_scale", 0),
        ("final_norm.bias", (d,), w, "norm_bias", 0),
    ]


def _layernorm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _rope(x, theta):
    """Rotate-half RoPE over x [B,S,H,hd] at positions 0..S-1."""
    s, hd = x.shape[1], x.shape[3]
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = ang.cos().float()[None, :, None, :]
    sin = ang.sin().float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def forward(params: dict, tokens: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Last-position logits [B, V] float32 of ``tokens`` [B, S]; ``params``
    are float32 tensors on the device the tokens are on."""
    z = sizes(cfg)
    h, hkv, hd = z["h"], z["hkv"], z["hd"]
    eps = cfg["layer_norm_epsilon"]
    window = cfg.get("sliding_window") or 0
    b, s = tokens.shape
    table = params["embed.table"]
    x = table[tokens]
    pos = torch.arange(s, device=x.device)
    visible = pos[:, None] >= pos[None, :]
    if window:
        visible &= (pos[:, None] - pos[None, :]) < window
    p = "slots.slot0."
    for i in range(z["layers"]):
        a = _layernorm(x, params[p + "norm1.scale"][i],
                       params[p + "norm1.bias"][i], eps)
        q = (a @ params[p + "attn.wq"][i]).view(b, s, h, hd)
        k = (a @ params[p + "attn.wk"][i]).view(b, s, hkv, hd)
        v = (a @ params[p + "attn.wv"][i]).view(b, s, hkv, hd)
        q = _rope(q, cfg["rope_theta"]).transpose(1, 2)     # [B,H,S,hd]
        k = _rope(k, cfg["rope_theta"]).transpose(1, 2)
        v = v.transpose(1, 2)
        k = k.repeat_interleave(h // hkv, dim=1)            # head j -> j // g
        v = v.repeat_interleave(h // hkv, dim=1)
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        scores = scores.masked_fill(~visible, float("-inf"))
        o = (scores.softmax(-1) @ v).transpose(1, 2).reshape(b, s, h * hd)
        x = x + o @ params[p + "attn.wo"][i]
        a = _layernorm(x, params[p + "norm2.scale"][i],
                       params[p + "norm2.bias"][i], eps)
        u = F.gelu(a @ params[p + "mlp.w_up"][i], approximate="tanh")
        x = x + u @ params[p + "mlp.w_down"][i]
    last = _layernorm(x[:, -1], params["final_norm.scale"],
                      params["final_norm.bias"], eps)
    return last @ table.T
