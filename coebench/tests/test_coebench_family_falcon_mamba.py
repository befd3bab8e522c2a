"""Falcon-Mamba's own checks: the plain reference against an independent
tiny computation in NumPy (loops over steps, channels and states, the
formulas written out), its chunked scan against the stepped recurrence, and
the full-width parameter and FLOP counts by hand."""
import math

import numpy as np
import pytest
import torch

from coebench import bench, reference, roofline
from coebench.reference import falcon_mamba
from coebench.tests import smoke

NAME = "falcon_mamba_7b_nomixnorm_x19"
# the independent computation's sizes
TINY = {"model_type": "falcon_mamba", "hidden_size": 4, "intermediate_size": 8,
        "state_size": 2, "time_step_rank": 2, "conv_kernel": 3,
        "num_hidden_layers": 2, "vocab_size": 11, "layer_norm_epsilon": 1e-5,
        "served_dtype": "float32", "tie_word_embeddings": False}


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


def test_reference_against_numpy():
    cfg = TINY
    p = smoke.params(cfg, seed=4)
    toks = np.random.default_rng(1).integers(0, cfg["vocab_size"], (3, 6))
    got = reference.family("falcon_mamba").forward(
        p, torch.from_numpy(toks), cfg).double().numpy()
    pn = {k: v.double().numpy() for k, v in p.items()}
    want = np.stack([mamba_numpy(pn, list(row), cfg) for row in toks])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def stepped(dt, xc, bm, cm, amat):
    """The recurrence one time step at a time, as the reference computed it
    before its scan was chunked."""
    b, s, di = xc.shape
    state = torch.zeros(b, di, amat.shape[-1])
    ys = []
    for t in range(s):
        state = (dt[:, t, :, None] * amat).exp() * state \
            + (dt[:, t] * xc[:, t])[:, :, None] * bm[:, t, None, :]
        ys.append((state * cm[:, t, None, :]).sum(-1))
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("chunk", [1, 5, falcon_mamba.CHUNK, 150, 512])
def test_chunked_scan_is_the_stepped_recurrence(chunk):
    """The chunked scan gives the stepped recurrence's read-out within
    float32 rounding, whether a chunk divides the sequence or not, with
    decays from near 1 to near 0 (dt log-uniform over 1e-3..3, A as
    S4D-real's -1..-16)."""
    gen = torch.Generator().manual_seed(3)
    b, s, di, n = 3, 150, 24, 16
    dt = torch.exp(torch.empty(b, s, di).uniform_(math.log(1e-3),
                                                  math.log(3.0),
                                                  generator=gen))
    xc = torch.randn(b, s, di, generator=gen)
    bm = torch.randn(b, s, n, generator=gen)
    cm = torch.randn(b, s, n, generator=gen)
    amat = -torch.arange(1, n + 1.0).expand(di, n)
    got = falcon_mamba.scan(dt, xc, bm, cm, amat, chunk)
    want = stepped(dt, xc, bm, cm, amat)
    assert got.shape == want.shape == (b, s, di)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_full_width_layout_sizes():
    """At the published widths, the parameters counted by hand: bf16 but
    Mamba's A and D in float32 (2.218 B parameters with the untied
    head)."""
    cfg = bench.Benchmark().config(NAME)
    layout = reference.family(cfg["model_type"]).layout(cfg)
    n16 = sum(torch.Size(s).numel() for _, s, dt, *_ in layout
              if dt == "bfloat16")
    n32 = sum(torch.Size(s).numel() for _, s, dt, *_ in layout
              if dt == "float32")
    d, di, n, rk, v, layers = 4096, 8192, 16, 256, 65024, 16
    layer = (d + d * 2 * di + 4 * di + di + di * (rk + 2 * n) + rk * di
             + di + di * d)
    assert (n16, n32) == (2 * v * d + layers * layer + d,
                          layers * (di * n + di))


def test_prompt_flops_by_hand():
    fm = bench.Benchmark().config(NAME)
    d, di, n, rk, v = 4096, 8192, 16, 256, 65024
    per_token = (2 * d * 2 * di + 2 * 4 * di + 2 * di * (rk + 2 * n)
                 + 2 * rk * di + 4 * di * n + 2 * di * d)
    assert roofline.prompt_flops(fm, 1024) == 16 * 1024 * per_token \
        + 2 * d * v
    # a 1024-token request through both stages: about 6.9 TFLOP
    assert 2 * roofline.prompt_flops(fm, 1024) == pytest.approx(6.9e12,
                                                                rel=0.01)
