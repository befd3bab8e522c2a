"""Plain float32 reference of a Jamba2-Mini stage expert
(ai21labs/AI21-Jamba2-Mini, the transformers ``JambaForCausalLM``): pre-RMSNorm
layers whose mixer is Mamba-1 or, once a period (``attn_layer_period`` at
``attn_layer_offset``), causal GQA attention with no positional encoding,
each followed by an FFN: a SwiGLU MLP, or, every ``expert_layer_period``-th
layer from ``expert_layer_offset``, a sparse MoE of SwiGLU experts; a final
RMSNorm and an untied head.

The Mamba mixer is ``JambaMambaMixer``'s: the in-projection split into x and
the gate z, a depthwise causal conv with bias, SiLU, the x-projection split
into dt, B and C, each of the three through a weighted RMSNorm
(``dt_layernorm``, ``b_layernorm``, ``c_layernorm``), dt's projection with
its bias and a softplus, the selective scan (``falcon_mamba.scan``, the
plain recurrence chunked over time) with the D skip, gated by SiLU(z), the
out-projection. The MoE is ``JambaSparseMoeBlock``'s: the router's softmax
over all ``router_experts`` in float32, the top ``num_experts_per_tok``
probabilities kept as they are (not renormalised), no token dropped.

Departures, each the configuration's cut (its ``changed_from_source``): the
stage has ``num_hidden_layers`` of the published 32 (whole periods), and of
each MoE layer only experts 0 .. ``num_experts`` - 1 are held: a choice of
another expert adds nothing, as on the card that holds this share. Norms,
products and the scan run in float32 throughout, where the published model
runs in bfloat16.

It reads its sizes from the configuration file's published keys and its
weights from the flat parameter names that ``layout`` lists (the port's
layout, which the benchmark's weight maker fills). No kernel, no cache, no
batching across rows. It imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .falcon_mamba import scan      # the selective scan, shared with FM


def sizes(cfg: dict) -> dict:
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    return {"d": d, "h": h, "hkv": cfg["num_key_value_heads"], "hd": d // h,
            "ff": cfg["intermediate_size"],
            "di": cfg["mamba_expand"] * d, "n": cfg["mamba_d_state"],
            "rk": cfg["mamba_dt_rank"], "w": cfg["mamba_d_conv"],
            "e": cfg["router_experts"], "held": cfg["num_experts"],
            "k": cfg["num_experts_per_tok"], "v": cfg["vocab_size"],
            "layers": cfg["num_hidden_layers"]}


def pattern(cfg: dict):
    """(mixer, ffn) of each slot of one period: "attn" or "mamba", "moe" or
    "mlp"."""
    ap, ao = cfg["attn_layer_period"], cfg["attn_layer_offset"]
    ep, eo = cfg["expert_layer_period"], cfg["expert_layer_offset"]
    period = ap * ep // math.gcd(ap, ep)
    return [("attn" if i % ap == ao else "mamba",
             "moe" if i % ep == eo else "mlp") for i in range(period)]


def layout(cfg: dict):
    """(flat name, shape, dtype, init, fan-in) of every weight, each slot of
    the period stacked along a leading axis of periods; ``served_dtype`` is
    the served dtype. Mamba's A and D are kept in float32, as the program
    keeps them."""
    z = sizes(cfg)
    d, h, hkv, hd, ff = z["d"], z["h"], z["hkv"], z["hd"], z["ff"]
    di, n, rk, w = z["di"], z["n"], z["rk"], z["w"]
    slots = pattern(cfg)
    ps = z["layers"] // len(slots)
    t = cfg["served_dtype"]
    out = [("embed.table", (z["v"], d), t, "dense", d)]
    for i, (mixer, ffn) in enumerate(slots):
        s = f"slots.slot{i}."
        out.append((s + "norm1.scale", (ps, d), t, "norm_scale", 0))
        if mixer == "attn":
            a = s + "attn."
            out += [(a + "wq", (ps, d, h * hd), t, "dense", d),
                    (a + "wk", (ps, d, hkv * hd), t, "dense", d),
                    (a + "wv", (ps, d, hkv * hd), t, "dense", d),
                    (a + "wo", (ps, h * hd, d), t, "dense", h * hd)]
        else:
            m = s + "mamba."
            out += [(m + "in_proj", (ps, d, 2 * di), t, "dense", d),
                    (m + "conv_w", (ps, w, di), t, "dense", w),
                    (m + "conv_b", (ps, di), t, "norm_bias", 0),
                    (m + "x_proj", (ps, di, rk + 2 * n), t, "dense", di),
                    (m + "dt_proj", (ps, rk, di), t, "dense", rk),
                    (m + "dt_bias", (ps, di), t, "dt_bias", 0),
                    (m + "A_log", (ps, di, n), "float32", "a_log", 0),
                    (m + "D", (ps, di), "float32", "skip", 0),
                    (m + "out_proj", (ps, di, d), t, "dense", di),
                    (m + "dt_norm", (ps, rk), t, "norm_scale", 0),
                    (m + "b_norm", (ps, n), t, "norm_scale", 0),
                    (m + "c_norm", (ps, n), t, "norm_scale", 0)]
        out.append((s + "norm2.scale", (ps, d), t, "norm_scale", 0))
        if ffn == "moe":
            e = s + "moe."
            out += [(e + "router", (ps, d, z["e"]), t, "dense", d),
                    (e + "w_in", (ps, z["held"], d, 2, ff), t, "dense", d),
                    (e + "w_down", (ps, z["held"], ff, d), t, "dense", ff)]
        else:
            out += [(s + "mlp.w_in", (ps, d, 2, ff), t, "dense", d),
                    (s + "mlp.w_down", (ps, ff, d), t, "dense", ff)]
    out.append(("final_norm.scale", (d,), t, "norm_scale", 0))
    out.append(("lm_head.table", (z["v"], d), t, "dense", d))
    return out


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _swiglu(a, w_in, w_down):
    return (F.silu(a @ w_in[:, 0]) * (a @ w_in[:, 1])) @ w_down


def _mamba(a, p, z, eps):
    s, n, rk, w = a.shape[1], z["n"], z["rk"], z["w"]
    xi, gate = (a @ p["in_proj"]).chunk(2, dim=-1)
    xp = F.pad(xi, (0, 0, w - 1, 0))
    xc = F.silu(p["conv_b"] + sum(xp[:, j:j + s] * p["conv_w"][j]
                                  for j in range(w)))
    dt_r, bm, cm = (xc @ p["x_proj"]).split([rk, n, n], -1)
    dt_r = _rmsnorm(dt_r, p["dt_norm"], eps)
    bm = _rmsnorm(bm, p["b_norm"], eps)
    cm = _rmsnorm(cm, p["c_norm"], eps)
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"])       # [B,S,di]
    y = scan(dt, xc, bm, cm, -p["A_log"].exp()) + p["D"] * xc
    return (y * F.silu(gate)) @ p["out_proj"]


def _attention(a, p, z):
    b, s, _ = a.shape
    h, hkv, hd = z["h"], z["hkv"], z["hd"]
    q = (a @ p["wq"]).view(b, s, h, hd).transpose(1, 2)        # [B,H,S,hd]
    k = (a @ p["wk"]).view(b, s, hkv, hd).transpose(1, 2)
    v = (a @ p["wv"]).view(b, s, hkv, hd).transpose(1, 2)
    k = k.repeat_interleave(h // hkv, dim=1)            # head j -> j // g
    v = v.repeat_interleave(h // hkv, dim=1)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    visible = torch.ones(s, s, dtype=torch.bool, device=a.device).tril()
    scores = scores.masked_fill(~visible, float("-inf"))
    o = (scores.softmax(-1) @ v).transpose(1, 2).reshape(b, s, h * hd)
    return o @ p["wo"]


def _moe(a, p, z):
    """Every token's top-k experts over the router's softmax, their
    probabilities as weights; the held experts' outputs only."""
    flat = a.reshape(-1, a.shape[-1])
    probs = torch.softmax(flat @ p["router"], dim=-1)
    top_w, top_i = torch.topk(probs, z["k"], dim=-1)
    out = torch.zeros_like(flat)
    for e in range(z["held"]):
        rows, choice = torch.nonzero(top_i == e, as_tuple=True)
        if rows.numel():
            y = _swiglu(flat[rows], p["w_in"][e], p["w_down"][e])
            out.index_add_(0, rows, top_w[rows, choice, None] * y)
    return out.view(a.shape)


def forward(params: dict, tokens: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Last-position logits [B, V] float32 of ``tokens`` [B, S]; ``params``
    are float32 tensors on the device the tokens are on."""
    z = sizes(cfg)
    eps = cfg["rms_norm_eps"]
    slots = pattern(cfg)
    x = params["embed.table"][tokens]
    for i in range(z["layers"]):
        period, slot = divmod(i, len(slots))
        mixer, ffn = slots[slot]
        pre = f"slots.slot{slot}."
        sub = {k[len(pre):]: v[period] for k, v in params.items()
               if k.startswith(pre)}
        a = _rmsnorm(x, sub["norm1.scale"], eps)
        part = {k.split(".", 1)[1]: v for k, v in sub.items()
                if k.startswith(mixer + ".")}
        x = x + (_attention(a, part, z) if mixer == "attn"
                 else _mamba(a, part, z, eps))
        a = _rmsnorm(x, sub["norm2.scale"], eps)
        if ffn == "moe":
            part = {k[4:]: v for k, v in sub.items() if k.startswith("moe.")}
            x = x + _moe(a, part, z)
        else:
            x = x + _swiglu(a, sub["mlp.w_in"], sub["mlp.w_down"])
    last = _rmsnorm(x[:, -1], params["final_norm.scale"], eps)
    return last @ params["lm_head.table"].T
