"""Plain float32 reference of a Falcon-Mamba expert (tiiuae/falcon-mamba-7b,
arXiv:2410.05355): pre-RMSNorm Mamba-1 layers (in-projection split into x
and the gate z, a depthwise causal conv with bias, SiLU, the x-projection to
dt, B and C, dt's projection with its bias and a softplus, the selective
scan as the plain sequential recurrence h_t = exp(dt A) h_{t-1} + dt x B,
y = C h + D x, gated by SiLU(z), the out-projection), a final RMSNorm and
the head: its own table where ``tie_word_embeddings`` is false, as
published, else the embedding's.

It reads its sizes from the configuration file's published keys and its
weights from the flat parameter names that ``layout`` lists (the port's
layout, which the benchmark's weight maker fills). No kernel, no cache, no
batching across rows. Falcon-Mamba's RMS norms of B, C and dt inside the
mixer are not applied, as the served program does not apply them (see the
configuration file's ``not_run``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def sizes(cfg: dict) -> dict:
    return {"d": cfg["hidden_size"], "di": cfg["intermediate_size"],
            "n": cfg["state_size"], "rk": cfg["time_step_rank"],
            "w": cfg["conv_kernel"], "v": cfg["vocab_size"],
            "layers": cfg["num_hidden_layers"]}


def layout(cfg: dict):
    """(flat name, shape, dtype, init, fan-in) of every weight, the layers
    stacked along a leading axis; ``cfg["served_dtype"]`` is the served
    dtype. A and D are kept in float32, as the program keeps them."""
    z = sizes(cfg)
    d, di, n, rk, w, v, ls = (z["d"], z["di"], z["n"], z["rk"], z["w"],
                              z["v"], z["layers"])
    t = cfg["served_dtype"]
    m = "slots.slot0.mamba."
    return [
        ("embed.table", (v, d), t, "dense", d),
        ("slots.slot0.norm1.scale", (ls, d), t, "norm_scale", 0),
        (m + "in_proj", (ls, d, 2 * di), t, "dense", d),
        (m + "conv_w", (ls, w, di), t, "dense", w),
        (m + "conv_b", (ls, di), t, "norm_bias", 0),
        (m + "x_proj", (ls, di, rk + 2 * n), t, "dense", di),
        (m + "dt_proj", (ls, rk, di), t, "dense", rk),
        (m + "dt_bias", (ls, di), t, "dt_bias", 0),
        (m + "A_log", (ls, di, n), "float32", "a_log", 0),
        (m + "D", (ls, di), "float32", "skip", 0),
        (m + "out_proj", (ls, di, d), t, "dense", di),
        ("final_norm.scale", (d,), t, "norm_scale", 0),
    ] + ([] if cfg["tie_word_embeddings"] else
         [("lm_head.table", (v, d), t, "dense", d)])


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def forward(params: dict, tokens: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Last-position logits [B, V] float32 of ``tokens`` [B, S]; ``params``
    are float32 tensors on the device the tokens are on."""
    z = sizes(cfg)
    rk, n, w = z["rk"], z["n"], z["w"]
    eps = cfg["layer_norm_epsilon"]
    b, s = tokens.shape
    table = params["embed.table"]
    x = table[tokens]
    m = "slots.slot0.mamba."
    for i in range(z["layers"]):
        a = _rmsnorm(x, params["slots.slot0.norm1.scale"][i], eps)
        xi, gate = (a @ params[m + "in_proj"][i]).chunk(2, dim=-1)
        conv_w = params[m + "conv_w"][i]                     # [W, di]
        xp = F.pad(xi, (0, 0, w - 1, 0))
        xc = params[m + "conv_b"][i] + sum(
            xp[:, j:j + s] * conv_w[j] for j in range(w))
        xc = F.silu(xc)
        dt_r, bm, cm = (xc @ params[m + "x_proj"][i]).split([rk, n, n], -1)
        dt = F.softplus(dt_r @ params[m + "dt_proj"][i]
                        + params[m + "dt_bias"][i])          # [B,S,di]
        amat = -params[m + "A_log"][i].exp()                 # [di, n]
        state = torch.zeros(b, xc.shape[-1], n, device=x.device)
        ys = []
        for t in range(s):
            state = (dt[:, t, :, None] * amat).exp() * state \
                + (dt[:, t] * xc[:, t])[:, :, None] * bm[:, t, None, :]
            ys.append((state * cm[:, t, None, :]).sum(-1))
        y = torch.stack(ys, dim=1) + params[m + "D"][i] * xc
        x = x + (y * F.silu(gate)) @ params[m + "out_proj"][i]
    last = _rmsnorm(x[:, -1], params["final_norm.scale"], eps)
    return last @ params.get("lm_head.table", table).T
