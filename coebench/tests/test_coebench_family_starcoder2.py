"""StarCoder2's own checks: the plain reference against an independent tiny
computation in NumPy (loops over heads and positions, the formulas written
out), and the full-width parameter and FLOP counts by hand."""
import math

import numpy as np
import pytest
import torch

from coebench import bench, reference, roofline
from coebench.tests import smoke

NAME = "starcoder2_3b_nobias_x14"
# the independent computation's sizes
TINY = {"model_type": "starcoder2", "hidden_size": 8, "intermediate_size": 16,
        "num_attention_heads": 2, "num_key_value_heads": 1,
        "num_hidden_layers": 2, "vocab_size": 11, "layer_norm_epsilon": 1e-5,
        "rope_theta": 100.0, "sliding_window": 3, "served_dtype": "float32"}


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


def test_reference_against_numpy():
    cfg = TINY
    p = smoke.params(cfg, seed=4)
    toks = np.random.default_rng(1).integers(0, cfg["vocab_size"], (3, 6))
    got = reference.family("starcoder2").forward(
        p, torch.from_numpy(toks), cfg).double().numpy()
    pn = {k: v.double().numpy() for k, v in p.items()}
    want = np.stack([starcoder2_numpy(pn, list(row), cfg) for row in toks])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_full_width_layout_sizes():
    """At the published widths, the parameters counted by hand: d 3072, 24
    query and 2 KV heads of 128, ff 12288, the head tied; all bf16 (3.030 B
    parameters)."""
    cfg = bench.Benchmark().config(NAME)
    layout = reference.family(cfg["model_type"]).layout(cfg)
    n16 = sum(torch.Size(s).numel() for _, s, dt, *_ in layout
              if dt == "bfloat16")
    n32 = sum(torch.Size(s).numel() for _, s, dt, *_ in layout
              if dt == "float32")
    d, kv, ff, v, layers = 3072, 256, 12288, 49152, 30
    layer = 4 * d + 2 * d * d + 2 * d * kv + 2 * d * ff
    assert (n16, n32) == (v * d + layers * layer + 2 * d, 0)


def test_prompt_flops_by_hand():
    sc = bench.Benchmark().config(NAME)
    d, ff, kv, v = 3072, 12288, 256, 49152
    per_token = 2 * d * d * 2 + 2 * 2 * d * kv + 2 * 2 * d * ff
    attn = 4 * 24 * 128 * (128 * 129 // 2)
    assert roofline.prompt_flops(sc, 128) == 30 * (128 * per_token + attn) \
        + 2 * d * v
    # a 1024-token request through both stages: about 12.2 TFLOP
    assert 2 * roofline.prompt_flops(sc, 1024) == pytest.approx(12.2e12,
                                                                rel=0.01)
