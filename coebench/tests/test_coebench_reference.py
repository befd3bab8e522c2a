"""The plain references against an independent tiny computation in NumPy
(loops over heads, positions and steps, the formulas written out), and
against the program computing in float32 at smoke widths."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from coebench import cell, reference, weights
from coebench.tests import smoke


def _params(cfg, seed=0):
    layout = reference.family(cfg["model_type"]).layout(cfg)
    named, _, _ = weights.make_expert(layout, seed, torch.device("cpu"))
    return {k: v.float() for k, v in named.items()}


def _tiny(model_type):
    if model_type == "starcoder2":
        return {"model_type": "starcoder2", "hidden_size": 8,
                "intermediate_size": 16, "num_attention_heads": 2,
                "num_key_value_heads": 1, "num_hidden_layers": 2,
                "vocab_size": 11, "layer_norm_epsilon": 1e-5,
                "rope_theta": 100.0, "sliding_window": 3,
                "served_dtype": "float32"}
    return {"model_type": "falcon_mamba", "hidden_size": 4,
            "intermediate_size": 8, "state_size": 2, "time_step_rank": 2,
            "conv_kernel": 3, "num_hidden_layers": 2, "vocab_size": 11,
            "layer_norm_epsilon": 1e-5, "served_dtype": "float32",
            "tie_word_embeddings": False}


def _np(p):
    return {k: v.double().numpy() for k, v in p.items()}


def _ln(x, g, b, eps):
    mu = x.mean()
    return (x - mu) / math.sqrt(((x - mu) ** 2).mean() + eps) * g + b


def _gelu(x):
    return 0.5 * x * (1 + np.tanh(math.sqrt(2 / math.pi)
                                  * (x + 0.044715 * x ** 3)))


def starcoder2_numpy(p, toks, cfg):
    d, h, hkv = (cfg["hidden_size"], cfg["num_attention_heads"],
                 cfg["num_key_value_heads"])
    hd, eps, win = d // h, cfg["layer_norm_epsilon"], cfg["sliding_window"]
    s = len(toks)
    x = np.stack([p["embed.table"][t] for t in toks])
    pre = "slots.slot0."

    def rope(v, pos):
        out = v.copy()
        for i in range(hd // 2):
            ang = pos / cfg["rope_theta"] ** (2 * i / hd)
            a, b = v[i], v[i + hd // 2]
            out[i] = a * math.cos(ang) - b * math.sin(ang)
            out[i + hd // 2] = b * math.cos(ang) + a * math.sin(ang)
        return out

    for li in range(cfg["num_hidden_layers"]):
        g = {k[len(pre):]: v[li] for k, v in p.items() if k.startswith(pre)}
        a = np.stack([_ln(r, g["norm1.scale"], g["norm1.bias"], eps)
                      for r in x])
        q, k, v = a @ g["attn.wq"], a @ g["attn.wk"], a @ g["attn.wv"]
        out = np.zeros((s, h * hd))
        for head in range(h):
            kvh = head // (h // hkv)
            for i in range(s):
                qi = rope(q[i, head * hd:(head + 1) * hd], i)
                js = [j for j in range(s) if j <= i and i - j < win]
                sc = np.array([qi @ rope(k[j, kvh * hd:(kvh + 1) * hd], j)
                               for j in js]) / math.sqrt(hd)
                w = np.exp(sc - sc.max())
                w /= w.sum()
                out[i, head * hd:(head + 1) * hd] = sum(
                    wj * v[j, kvh * hd:(kvh + 1) * hd]
                    for wj, j in zip(w, js))
        x = x + out @ g["attn.wo"]
        a = np.stack([_ln(r, g["norm2.scale"], g["norm2.bias"], eps)
                      for r in x])
        x = x + _gelu(a @ g["mlp.w_up"]) @ g["mlp.w_down"]
    last = _ln(x[-1], p["final_norm.scale"], p["final_norm.bias"], eps)
    return p["embed.table"] @ last


def mamba_numpy(p, toks, cfg):
    di, n, rk, w = (cfg["intermediate_size"], cfg["state_size"],
                    cfg["time_step_rank"], cfg["conv_kernel"])
    eps = cfg["layer_norm_epsilon"]
    x = np.stack([p["embed.table"][t] for t in toks])
    s = len(toks)
    pre = "slots.slot0.mamba."

    def rms(r, g):
        return r / math.sqrt((r ** 2).mean() + eps) * g

    def silu(v):
        return v / (1 + np.exp(-v))

    for li in range(cfg["num_hidden_layers"]):
        g = {k[len(pre):]: v[li] for k, v in p.items() if k.startswith(pre)}
        a = np.stack([rms(r, p["slots.slot0.norm1.scale"][li]) for r in x])
        xz = a @ g["in_proj"]
        xi, z = xz[:, :di], xz[:, di:]
        xc = np.zeros((s, di))
        for t in range(s):
            xc[t] = g["conv_b"] + sum(g["conv_w"][j] * xi[t - (w - 1) + j]
                                      for j in range(w)
                                      if t - (w - 1) + j >= 0)
        xc = silu(xc)
        proj = xc @ g["x_proj"]
        dt = np.log1p(np.exp(proj[:, :rk] @ g["dt_proj"] + g["dt_bias"]))
        bm, cm = proj[:, rk:rk + n], proj[:, rk + n:]
        amat = -np.exp(g["A_log"])
        hstate = np.zeros((di, n))
        y = np.zeros((s, di))
        for t in range(s):
            for c in range(di):
                for m in range(n):
                    hstate[c, m] = (math.exp(dt[t, c] * amat[c, m])
                                    * hstate[c, m]
                                    + dt[t, c] * xc[t, c] * bm[t, m])
                y[t, c] = hstate[c] @ cm[t] + g["D"][c] * xc[t, c]
        x = x + (y * silu(z)) @ g["out_proj"]
    last = rms(x[-1], p["final_norm.scale"])
    return p["lm_head.table"] @ last


@pytest.mark.parametrize("model_type,plain", [("starcoder2", starcoder2_numpy),
                                              ("falcon_mamba", mamba_numpy)])
def test_reference_against_numpy(model_type, plain):
    cfg = _tiny(model_type)
    p = _params(cfg, seed=4)
    toks = np.random.default_rng(1).integers(0, cfg["vocab_size"], (3, 6))
    got = reference.family(model_type).forward(
        p, torch.from_numpy(toks), cfg).double().numpy()
    want = np.stack([plain(_np(p), list(row), cfg) for row in toks])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["starcoder2_3b_nobias_x14",
                                  "falcon_mamba_7b_nomixnorm_x19"])
def test_reference_is_the_programs_function(name):
    """The program computing in float32 on its plain path gives the
    reference's logits at smoke widths: the two compute one function."""
    from repro_torch.convert import nest_params
    from repro_torch.models import transformer

    cfg = smoke.config(name)
    cfg["served_dtype"] = "float32"
    cfg["port"]["overrides"].update(param_dtype="float32")
    pc = dataclasses.replace(cell.port_config(cfg), compute_dtype="float32",
                             attn_impl="xla")
    p = _params(cfg, seed=9)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg["vocab_size"], (3, 40)).astype(np.int32))
    with torch.no_grad():
        prog = transformer.forward(nest_params(p), toks, pc,
                                   mode="eval")[0][:, -1]
        ref = reference.family(cfg["model_type"]).forward(p, toks.long(),
                                                          cfg)
    torch.testing.assert_close(prog, ref, rtol=2e-4, atol=2e-4)
