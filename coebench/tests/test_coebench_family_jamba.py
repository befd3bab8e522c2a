"""Jamba's own checks: the plain reference against an independent tiny
computation in NumPy (loops over steps, channels, states, heads and
choices, the formulas written out) at one whole 8-layer period with 4
router experts of which 2 are held, top-2; the program computing in
float32 against the reference at smoke widths; the full-width parameter
count, prompt FLOPs and launches by hand. These tests read the
configuration's file; the generic checks take it from ``BENCHMARK.json``."""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from coebench import bench, cell, reference, roofline
from coebench.tests import smoke

NAME = "jamba2_mini_l8e8_x5"
# the independent computation's sizes: one whole period (attention at 4,
# MoE on the odd layers), 4 router experts, 2 held, top-2
TINY = {"model_type": "jamba", "hidden_size": 8, "intermediate_size": 6,
        "num_attention_heads": 2, "num_key_value_heads": 1,
        "mamba_expand": 2, "mamba_d_state": 3, "mamba_dt_rank": 2,
        "mamba_d_conv": 3, "attn_layer_period": 8, "attn_layer_offset": 4,
        "expert_layer_period": 2, "expert_layer_offset": 1,
        "router_experts": 4, "num_experts": 2, "num_experts_per_tok": 2,
        "num_hidden_layers": 8, "vocab_size": 11, "rms_norm_eps": 1e-6,
        "served_dtype": "float32", "tie_word_embeddings": False}


def stage_config() -> dict:
    return json.loads((bench.HERE / "configs" / f"{NAME}.json").read_text())


def jamba_numpy(p, toks, cfg):
    d = cfg["hidden_size"]
    di, n = cfg["mamba_expand"] * d, cfg["mamba_d_state"]
    rk, w = cfg["mamba_dt_rank"], cfg["mamba_d_conv"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    eps = cfg["rms_norm_eps"]
    s = len(toks)
    x = np.stack([p["embed.table"][t] for t in toks])

    def rms(r, g):
        return r / math.sqrt((r ** 2).mean() + eps) * g

    def silu(v):
        return v / (1 + np.exp(-v))

    def swiglu(r, w_in, w_down):
        return (silu(r @ w_in[:, 0]) * (r @ w_in[:, 1])) @ w_down

    for li in range(cfg["num_hidden_layers"]):
        pre = f"slots.slot{li}."
        g = {k[len(pre):]: v[0] for k, v in p.items() if k.startswith(pre)}
        a = np.stack([rms(r, g["norm1.scale"]) for r in x])
        if li % 8 == 4:                       # attention, no RoPE
            q = a @ g["attn.wq"]
            k = a @ g["attn.wk"]
            v = a @ g["attn.wv"]
            o = np.zeros((s, h * hd))
            for head in range(h):
                kv = head // (h // hkv)
                for t in range(s):
                    sc = [q[t, head * hd:(head + 1) * hd]
                          @ k[u, kv * hd:(kv + 1) * hd] / math.sqrt(hd)
                          for u in range(t + 1)]
                    e = np.exp(np.array(sc) - max(sc))
                    e /= e.sum()
                    o[t, head * hd:(head + 1) * hd] = sum(
                        e[u] * v[u, kv * hd:(kv + 1) * hd]
                        for u in range(t + 1))
            x = x + o @ g["attn.wo"]
        else:                                 # Mamba with dt, B, C norms
            m = {k[6:]: v for k, v in g.items() if k.startswith("mamba.")}
            xz = a @ m["in_proj"]
            xi, z = xz[:, :di], xz[:, di:]
            xc = np.zeros((s, di))
            for t in range(s):
                xc[t] = m["conv_b"] + sum(
                    m["conv_w"][j] * xi[t - (w - 1) + j] for j in range(w)
                    if t - (w - 1) + j >= 0)
            xc = silu(xc)
            proj = xc @ m["x_proj"]
            dt_r = np.stack([rms(r, m["dt_norm"]) for r in proj[:, :rk]])
            bm = np.stack([rms(r, m["b_norm"]) for r in proj[:, rk:rk + n]])
            cm = np.stack([rms(r, m["c_norm"]) for r in proj[:, rk + n:]])
            dt = np.log1p(np.exp(dt_r @ m["dt_proj"] + m["dt_bias"]))
            amat = -np.exp(m["A_log"])
            hstate = np.zeros((di, n))
            y = np.zeros((s, di))
            for t in range(s):
                for c in range(di):
                    for j in range(n):
                        hstate[c, j] = (math.exp(dt[t, c] * amat[c, j])
                                        * hstate[c, j]
                                        + dt[t, c] * xc[t, c] * bm[t, j])
                    y[t, c] = hstate[c] @ cm[t] + m["D"][c] * xc[t, c]
            x = x + (y * silu(z)) @ m["out_proj"]
        a = np.stack([rms(r, g["norm2.scale"]) for r in x])
        if li % 2 == 1:                       # MoE: top-2 of 4, 0-1 held
            out = np.zeros_like(x)
            for t in range(s):
                logit = a[t] @ g["moe.router"]
                prob = np.exp(logit - logit.max())
                prob /= prob.sum()
                for e in sorted(range(4), key=lambda j: -prob[j])[:2]:
                    if e < cfg["num_experts"]:
                        out[t] += prob[e] * swiglu(a[t], g["moe.w_in"][e],
                                                   g["moe.w_down"][e])
            x = x + out
        else:
            x = x + np.stack([swiglu(r, g["mlp.w_in"], g["mlp.w_down"])
                              for r in a])
    last = rms(x[-1], p["final_norm.scale"])
    return p["lm_head.table"] @ last


def test_reference_against_numpy():
    cfg = TINY
    p = smoke.params(cfg, seed=4)
    toks = np.random.default_rng(1).integers(0, cfg["vocab_size"], (3, 6))
    got = reference.family("jamba").forward(
        p, torch.from_numpy(toks), cfg).double().numpy()
    pn = {k: v.double().numpy() for k, v in p.items()}
    want = np.stack([jamba_numpy(pn, list(row), cfg) for row in toks])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_the_program_computes_the_reference():
    """The program computing in float32 on its plain path gives the
    reference's logits at smoke widths (the generic
    ``test_reference_is_the_programs_function`` for this configuration)."""
    from repro_torch.convert import nest_params
    from repro_torch.models import transformer

    cfg = smoke.config(NAME)
    cfg["served_dtype"] = "float32"
    cfg["port"]["overrides"].update(param_dtype="float32")
    pc = dataclasses.replace(cell.port_config(cfg), compute_dtype="float32",
                             attn_impl="xla")
    p = smoke.params(cfg, seed=9)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg["vocab_size"], (3, 40)).astype(np.int32))
    with torch.no_grad():
        prog = transformer.forward(nest_params(p), toks, pc,
                                   mode="eval")[0][:, -1]
        ref = reference.family("jamba").forward(p, toks.long(), cfg)
    torch.testing.assert_close(prog, ref, rtol=2e-4, atol=2e-4)


def test_an_expert_not_held_adds_nothing():
    """Holding experts 0-1 of 4 is holding all four with experts 2-3's
    weights zeroed, and differs from holding all four: their choices
    happen and add nothing."""
    whole = dict(TINY, num_experts=4)
    fam = reference.family("jamba")
    pw = smoke.params(whole, seed=5)
    held = {k: v[:, :2] if ".moe.w_" in k else v for k, v in pw.items()}
    zeroed = {k: torch.cat([v[:, :2], 0 * v[:, 2:]], 1)
              if ".moe.w_" in k else v for k, v in pw.items()}
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, TINY["vocab_size"], (2, 5)))
    got = fam.forward(held, toks, TINY)
    torch.testing.assert_close(fam.forward(zeroed, toks, whole), got,
                               rtol=1e-6, atol=1e-6)
    assert not torch.allclose(fam.forward(pw, toks, whole), got, atol=1e-3)


def test_full_width_layout_sizes():
    """At the published widths, the stage's parameters counted by hand:
    7,658,092,512 (bf16 but Mamba's A and D in float32), 15.32 GB."""
    cfg = stage_config()
    layout = reference.family(cfg["model_type"]).layout(cfg)
    n16 = sum(math.prod(s) for _, s, dt, *_ in layout if dt == "bfloat16")
    n32 = sum(math.prod(s) for _, s, dt, *_ in layout if dt == "float32")
    d, ff, v, di, n, rk = 4096, 14336, 65536, 8192, 16, 256
    h, hkv, hd, held, experts = 32, 8, 128, 8, 16
    mamba = (d + d * 2 * di + 4 * di + di + di * (rk + 2 * n) + rk * di
             + di + di * d + rk + 2 * n)
    attn = d + d * h * hd + 2 * d * hkv * hd + h * hd * d
    mlp = d + 3 * d * ff
    moe = d + d * experts + held * 3 * d * ff
    assert n16 == 2 * v * d + 7 * mamba + attn + 4 * mlp + 4 * moe + d
    assert n32 == 7 * (di * n + di)
    assert n16 + n32 == 7_658_092_512
    assert 2 * n16 + 4 * n32 == pytest.approx(15.32e9, rel=1e-3)


def test_prompt_flops_and_launches_by_hand():
    cfg = stage_config()
    d, ff, v, di, n, rk = 4096, 14336, 65536, 8192, 16, 256
    h, hkv, hd, s = 32, 8, 128, 128
    mamba = (2 * d * 2 * di + 2 * 4 * di + 2 * di * (rk + 2 * n)
             + 2 * rk * di + 4 * di * n + 2 * di * d)
    attn = 2 * d * h * hd + 2 * 2 * d * hkv * hd + 2 * h * hd * d
    swiglu = 6 * d * ff
    moe = 2 * d * 16 + (2 * 8 / 16) * swiglu     # one held expert a token
    want = (s * (7 * mamba + attn + 4 * swiglu + 4 * moe)
            + 4 * h * hd * s * (s + 1) // 2 + 2 * d * v)
    assert roofline.prompt_flops(cfg, s) == pytest.approx(want, rel=1e-12)
    assert roofline.prompt_flops(cfg, s) == pytest.approx(561.16e9,
                                                          rel=1e-4)
    got = roofline.launches(cfg, [(8, 6, 128)])
    assert {k: x["launches"] for k, x in got.items()} == {
        "mamba_scan": 7, "flash_attention": 1, "moe_grouped": 8}
    assert got["mamba_scan"]["bound_s"] == pytest.approx(
        7 * roofline.mamba_scan_launch(8, 128, di, n)["bound_s"])
    assert got["flash_attention"]["bound_s"] == pytest.approx(
        roofline.flash_attention_launch(8, h, hkv, 128, hd)["bound_s"])
    # 1024 tokens, 1024 held rows a layer: w_in and w_down of 8 experts
    # read once (2.82 GB a layer), x in and h out, h in and out out
    rows = 1024
    gate_up = (8 * d * 2 * ff + rows * (d + ff)) * 2 / 3.35e12
    down = (8 * ff * d + rows * (ff + d)) * 2 / 3.35e12
    assert 2 * rows * 3 * d * ff / 989e12 < down + gate_up
    assert got["moe_grouped"]["bound_s"] == pytest.approx(
        4 * (gate_up + down))
    assert 4 * (gate_up + down) == pytest.approx(4 * 0.864e-3, rel=1e-3)
