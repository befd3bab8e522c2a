"""Plain float32 reference of a Falcon-Mamba expert (tiiuae/falcon-mamba-7b,
arXiv:2410.05355): pre-RMSNorm Mamba-1 layers (in-projection split into x
and the gate z, a depthwise causal conv with bias, SiLU, the x-projection to
dt, B and C, dt's projection with its bias and a softplus, the selective
scan as the plain recurrence h_t = exp(dt A) h_{t-1} + dt x B, y = C h + D x,
chunked over time (``scan``), gated by SiLU(z), the out-projection), a final
RMSNorm and the head: its own table where ``tie_word_embeddings`` is false, as
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

CHUNK = 64      # time steps whose decays, inputs and read-out are formed at
#                 once: [B, 64, di, n] float32, 268 MB at B 8 and di 8192


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


def scan(dt, xc, bm, cm, amat, chunk: int = CHUNK) -> torch.Tensor:
    """The selective scan's read-out y_t = C_t h_t (the D skip left out) of
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t from h_0 = 0, over dt and x
    [B, S, di], B and C [B, S, n] and A [di, n]: for each chunk of
    ``chunk`` time steps the decays exp(dt A) and the inputs (dt x) B are
    formed at once, the state steps through the chunk with one
    multiply-add a step, and the chunk's states are read out by C at
    once."""
    b, s, di = xc.shape
    state = torch.zeros(b, di, amat.shape[-1], device=xc.device)
    ys = []
    for c0 in range(0, s, chunk):
        c1 = min(s, c0 + chunk)
        decay = (dt[:, c0:c1, :, None] * amat).exp()           # [B,L,di,n]
        inp = (dt[:, c0:c1] * xc[:, c0:c1])[..., None] \
            * bm[:, c0:c1, None, :]
        states = torch.empty_like(decay)
        for t in range(c1 - c0):
            state = torch.addcmul(inp[:, t], decay[:, t], state,
                                  out=states[:, t])
        ys.append((states * cm[:, c0:c1, None, :]).sum(-1))
        del decay, inp, states
    return torch.cat(ys, dim=1)


def forward(params: dict, tokens: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Last-position logits [B, V] float32 of ``tokens`` [B, S]; ``params``
    are float32 tensors on the device the tokens are on."""
    z = sizes(cfg)
    rk, n, w = z["rk"], z["n"], z["w"]
    eps = cfg["layer_norm_epsilon"]
    s = tokens.shape[1]
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
        y = scan(dt, xc, bm, cm, amat) + params[m + "D"][i] * xc
        x = x + (y * F.silu(gate)) @ params[m + "out_proj"][i]
    last = _rmsnorm(x[:, -1], params["final_norm.scale"], eps)
    return last @ params.get("lm_head.table", table).T
