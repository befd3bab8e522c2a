"""The dropless MoE layer over the experts a card holds
(``models/moe.py``, ``cfg.moe_dropless`` and ``cfg.moe_experts_held``),
its grouped kernel (``kernels/moe_grouped.py``), and Jamba's other two
switches: the mixer's dt, B and C norms (``cfg.ssm_dt_bc_norms``) and
attention without RoPE (``cfg.attn_rope``). Plain torch, no JAX.

On the CPU: the layer against a plain loop over tokens and choices, with
and without renormalising, where an expert gets no row and one gets a
single row; the shares of two cards (experts 0-1 and 2-3 of 4) adding up to
the uncut layer; the norms and the unrotated attention against plain
formulas; the forward span's MoE counters on a wall-traced run, and no
event on an untraced one; the op refusing a differentiable call.
Tolerances: float32 throughout, 1e-5 relative and 1e-5 of the largest
|value| absolute (sums taken in another order; token 0 of the shaped inputs
reaches outputs near 100).

Marked ``cuda`` (skip without a card): the kernel against its plain
version in bf16 at the benchmark cell's widths, with uneven, empty and
one-row segments, padded (all-zero) tokens and choices of experts not
held; the layer under ``torch.cuda.set_sync_debug_mode("error")``; the
kernel refusing a differentiable call.

    python -m pytest -q -m cuda tests/test_torch_moe_dropless.py
"""
import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import moe_grouped as grouped_mod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import moe_grouped_ref
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer
from repro_torch.obs import Tracer
from repro_torch.obs import tracer as obs_tracer

F32 = dict(rtol=1e-5, atol=1e-5)


def close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


def jamba2(**changes):
    """Jamba's smoke config (one 8-slot period: 7 Mamba and 1 attention,
    MoE on the odd slots, 4 experts top-2) with Jamba2-Mini's switches:
    dropless, weights not renormalised, no RoPE, the mixer's norms."""
    base = dict(moe_dropless=True, moe_renormalize=False, attn_rope=False,
                ssm_dt_bc_norms=True, norm_eps=1e-6)
    base.update(changes)
    return dataclasses.replace(smoke_config(get_config("jamba_v0_1_52b")),
                               **base)


def layer_cfg(**changes):
    base = dict(compute_dtype="float32", moe_num_experts=4, moe_top_k=2)
    base.update(changes)
    return jamba2(**base)


def plain_layer(p, x, cfg):
    """The layer token by token and choice by choice: softmax over all the
    router's experts, the top k by probability (lower index first among
    equals), renormalised or not, each held expert's SwiGLU output weighted
    and added; the others add nothing."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).double()
    probs = torch.softmax(xf @ p["router"].double(), dim=-1)
    held = cfg.moe_experts_held or cfg.moe_num_experts
    y = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        chosen = sorted(range(cfg.moe_num_experts),
                        key=lambda j: (-probs[t, j].item(), j))
        chosen = chosen[:cfg.moe_top_k]
        w = probs[t, chosen]
        if cfg.moe_renormalize:
            w = w / w.sum()
        for c, j in enumerate(chosen):
            if j >= held:
                continue
            wi = p["w_in"][j].double()
            h = F.silu(xf[t] @ wi[:, 0]) * (xf[t] @ wi[:, 1])
            y[t] += w[c] * (h @ p["w_down"][j].double())
    return y.reshape(x.shape)


def shaped_inputs(cfg, seed):
    """Router and tokens under which, of 4 experts, expert 1 is never
    chosen and expert 0 only by token 0 (x >= 0; expert 1's router column
    negative; expert 0's negative but for feature 0, which only token 0
    has), so that a card holding experts 0-1 gets one row and an empty
    segment."""
    gen = torch.Generator().manual_seed(seed)
    p = moe.init_moe(gen, cfg, torch.float32)
    d = cfg.d_model
    full = moe.init_moe(gen, dataclasses.replace(cfg, moe_experts_held=0),
                        torch.float32)
    x = torch.rand((2, 5, d), generator=gen) + 0.1
    x[..., 0] = 0.0
    x[0, 0, 0] = 50.0
    router = full["router"].clone()
    router[:, 0] = -0.2
    router[0, 0] = 1.0
    router[:, 1] = -0.3
    for q in (p, full):
        q["router"] = router
    return p, full, x


@pytest.mark.parametrize("renormalize", [False, True],
                         ids=["published", "renormalised"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_held_layer_is_the_plain_loop(renormalize, impl):
    cfg = layer_cfg(moe_experts_held=2, moe_renormalize=renormalize,
                    attn_impl=impl)
    p, _, x = shaped_inputs(cfg, 0)
    probs = torch.softmax(x.reshape(-1, cfg.d_model) @ p["router"], -1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :2]
    assert (top == 0).sum() == 1 and not (top == 1).any()
    out, aux, load = moe.moe_block(p, x, cfg, torch.float32)
    close(out, plain_layer(p, x, cfg).float())
    assert load.tolist() == [int((top == j).sum()) for j in range(4)]
    assert torch.isfinite(aux)


def test_random_routing_with_more_experts():
    cfg = layer_cfg(moe_num_experts=16, moe_experts_held=8)
    gen = torch.Generator().manual_seed(3)
    p = moe.init_moe(gen, cfg, torch.float32)
    assert p["w_in"].shape[0] == 8 and p["router"].shape[1] == 16
    x = torch.randn((3, 7, cfg.d_model), generator=gen)
    out, _, _ = moe.moe_block(p, x, cfg, torch.float32)
    close(out, plain_layer(p, x, cfg).float())


@pytest.mark.parametrize("shaped", [True, False], ids=["shaped", "random"])
def test_the_two_cards_shares_add_up_to_the_uncut_layer(shaped):
    """Experts 0-1 on one card, 2-3 on the other: the router is whole on
    both, and their outputs add up to the layer with all four experts
    (``moe_experts_held`` 0), itself the plain loop. Each card holds its
    experts as its 0 and 1: the second card's router has the columns of
    experts 2-3 first."""
    whole = layer_cfg()
    if shaped:
        _, p, x = shaped_inputs(whole, 1)
    else:
        gen = torch.Generator().manual_seed(1)
        p = moe.init_moe(gen, whole, torch.float32)
        x = torch.randn((2, 6, whole.d_model), generator=gen)
    uncut = moe.moe_block(p, x, whole, torch.float32)[0]
    close(uncut, plain_layer(p, x, whole).float())
    cfg = layer_cfg(moe_experts_held=2)
    parts = []
    for perm in ([0, 1, 2, 3], [2, 3, 0, 1]):
        share = {"router": p["router"][:, perm],
                 "w_in": p["w_in"][perm[:2]],
                 "w_down": p["w_down"][perm[:2]]}
        parts.append(moe.moe_block(share, x, cfg, torch.float32)[0])
    close(parts[0] + parts[1], uncut)
    if shaped:      # the first card's share is token 0's expert 0 alone
        assert parts[0][0, 1:].abs().max() == 0 and parts[0][1].abs().max() \
            == 0 and parts[0][0, 0].abs().max() > 0


def test_held_experts_need_the_dropless_layer():
    cfg = layer_cfg(moe_experts_held=2, moe_dropless=False)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    with pytest.raises(ValueError, match="moe_dropless"):
        moe.moe_block(p, torch.zeros((1, 4, cfg.d_model)), cfg)


def test_grouped_plain_version_by_hand():
    """Segments of 0, 1 and 3 rows and two pairs of experts not held: each
    held pair's weighted SwiGLU output at its flat index, zero elsewhere."""
    gen = torch.Generator().manual_seed(5)
    d, ff, k = 8, 6, 2
    x = torch.randn((4, d), generator=gen)
    w_in = torch.randn((3, d, 2, ff), generator=gen)
    w_down = torch.randn((3, ff, d), generator=gen)
    weights = torch.rand(8, generator=gen)
    # pairs (token, choice) -> held expert: 0 none, 1 pair 5, 2 pairs 0, 3, 6
    order = torch.tensor([5, 0, 3, 6, 1, 2, 4, 7])
    offsets = torch.tensor([0, 0, 1, 4])
    out = moe_grouped_ref(x, order, offsets, weights, k, w_in, w_down)
    for pair in range(8):
        e = {5: 1, 0: 2, 3: 2, 6: 2}.get(pair)
        if e is None:
            assert out[pair].abs().max() == 0
            continue
        xt = x[pair // k]
        h = F.silu(xt @ w_in[e, :, 0]) * (xt @ w_in[e, :, 1])
        torch.testing.assert_close(out[pair], weights[pair] * (h @ w_down[e]),
                                   rtol=1e-5, atol=1e-4)


def test_the_op_refuses_a_differentiable_call():
    cfg = layer_cfg(moe_experts_held=2, attn_impl="pallas")
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    p["w_in"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="moe_grouped has no backward"):
        moe.moe_block(p, torch.randn((1, 4, cfg.d_model)), cfg,
                      torch.float32)
    with torch.no_grad():
        moe.moe_block(p, torch.randn((1, 4, cfg.d_model)), cfg,
                      torch.float32)


# --------------------------------------------------------------------------- #
# the mixer's norms, attention without RoPE
# --------------------------------------------------------------------------- #

def plain_rms(v, scale, eps):
    return v * torch.rsqrt(v.square().mean(-1, keepdim=True) + eps) * scale


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_dt_b_c_norms_are_plain_rmsnorms(impl):
    cfg = jamba2(compute_dtype="float32", attn_impl=impl)
    gen = torch.Generator().manual_seed(2)
    p = ssm_lib.init_mamba(gen, cfg, torch.float32)
    rk, st = cfg.dt_rank, cfg.ssm_state_dim
    for name, n in (("dt_norm", rk), ("b_norm", st), ("c_norm", st)):
        assert p[name].shape == (n,)
        p[name] = torch.rand(n, generator=gen) + 0.5
    x_c = torch.randn((2, 5, cfg.d_inner), generator=gen)
    dt, b_c, c_c = ssm_lib._ssm_inputs(p, x_c, cfg, torch.float32)
    dt_r, b_w, c_w = (x_c @ p["x_proj"]).split([rk, st, st], -1)
    eps = cfg.norm_eps
    want_dt = F.softplus(plain_rms(dt_r, p["dt_norm"], eps) @ p["dt_proj"]
                         + p["dt_bias"])
    torch.testing.assert_close(dt, want_dt, **F32)
    torch.testing.assert_close(b_c, plain_rms(b_w, p["b_norm"], eps), **F32)
    torch.testing.assert_close(c_c, plain_rms(c_w, p["c_norm"], eps), **F32)
    off = dataclasses.replace(cfg, ssm_dt_bc_norms=False)
    assert not {"dt_norm", "b_norm", "c_norm"} & set(
        ssm_lib.init_mamba(gen, off, torch.float32))
    torch.testing.assert_close(
        ssm_lib._ssm_inputs(p, x_c, off, torch.float32)[1], b_w, **F32)


def test_attention_without_rope_is_plain_causal_gqa():
    cfg = jamba2(compute_dtype="float32")
    gen = torch.Generator().manual_seed(4)
    p = L.init_attention(gen, cfg, torch.float32)
    b, s = 2, 9
    x = torch.randn((b, s, cfg.d_model), generator=gen)
    pos = torch.arange(s)[None].expand(b, s)
    out, _ = L.attention_block(p, x, cfg, pos, compute_dtype=torch.float32)
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).view(b, s, h, hd).transpose(1, 2)
    k = (x @ p["wk"]).view(b, s, hkv, hd).transpose(1, 2)
    v = (x @ p["wv"]).view(b, s, hkv, hd).transpose(1, 2)
    k, v = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
    scores = q @ k.transpose(-1, -2) / math.sqrt(hd)
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    o = scores.masked_fill(~mask, float("-inf")).softmax(-1) @ v
    want = o.transpose(1, 2).reshape(b, s, h * hd) @ p["wo"]
    torch.testing.assert_close(out, want, **F32)
    rotated, _ = L.attention_block(p, x, dataclasses.replace(
        cfg, attn_rope=True), pos, compute_dtype=torch.float32)
    assert (rotated - want).abs().max() > 1e-3


# --------------------------------------------------------------------------- #
# the forward span's counters
# --------------------------------------------------------------------------- #

def test_forward_span_counts_the_moe_rows(monkeypatch):
    cfg = jamba2(moe_experts_held=2)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.randint(0, cfg.vocab_size, (2, 8))
    chosen = []
    route = moe.route

    def recording(*a, **kw):
        out = route(*a, **kw)
        chosen.append(out[2])
        return out

    monkeypatch.setattr(moe, "route", recording)
    wall = Tracer("full", wall=True)
    with torch.no_grad():
        want, _ = transformer.forward(params, x, cfg)
        with obs_tracer.activated(wall):
            got, _ = transformer.forward(params, x, cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    (fwd,) = wall.events
    traced = chosen[len(chosen) // 2:]
    assert len(traced) == 4                 # the period's four MoE layers
    rows = sum(int((c < 2).sum()) for c in traced)
    # on the CPU the kernel's entry point runs its plain version, which
    # counts no launch
    assert fwd.attrs == {"tokens": 16, "norm_launches": 0,
                         "rope_launches": 0, "moe_launches": 0,
                         "moe_rows": rows, "moe_away": 4 * 16 * 2 - rows}
    assert 0 < rows < 4 * 16 * 2


def test_an_untraced_forward_makes_no_event(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("an untraced forward recorded")

    for name in ("emit", "open", "close", "span", "defer"):
        monkeypatch.setattr(Tracer, name, refuse)
    monkeypatch.setattr(obs_tracer, "Event", refuse)
    cfg = jamba2(moe_experts_held=2)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        logits, _ = transformer.forward(
            params, torch.randint(0, cfg.vocab_size, (2, 8)), cfg)
    assert torch.isfinite(logits).all()


def test_a_capacity_layer_counts_no_rows():
    """The capacity layer keeps no tally: its forward span carries the
    grouped kernel's launches (none) and no row counts."""
    cfg = smoke_config(get_config("mixtral_8x22b"))
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    wall = Tracer("full", wall=True)
    with torch.no_grad(), obs_tracer.activated(wall):
        transformer.forward(params, torch.zeros((2, 8), dtype=torch.int32),
                            cfg)
    (fwd,) = wall.events
    assert fwd.attrs == {"tokens": 16, "norm_launches": 0,
                         "rope_launches": 0, "moe_launches": 0}


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def grouped_inputs(device, t, d, ff, e, k, seed):
    """Tokens (the last eighth all zero, as ``bucket_pad``'s rows), bf16
    weights, and pairs sorted by held expert: expert 0 none, expert 1 one
    pair, expert 2 a third of them, the rest spread, a tenth not held."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((t, d), generator=gen, device=device).bfloat16()
    x[t - t // 8:] = 0
    w_in = (torch.randn((e, d, 2, ff), generator=gen, device=device)
            / math.sqrt(d)).bfloat16()
    w_down = (torch.randn((e, ff, d), generator=gen, device=device)
              / math.sqrt(ff)).bfloat16()
    pairs = t * k
    u = torch.rand(pairs, generator=gen, device=device)
    expert = torch.where(u < 0.33, 2, 3 + (u * 1e4).long() % (e - 3))
    expert = torch.where(u > 0.9, e, expert)          # not held
    expert[7] = 1
    expert = torch.where((expert == 1) & (torch.arange(pairs, device=device)
                                          != 7), 2, expert)
    counts = torch.zeros(e + 1, dtype=torch.long, device=device)
    counts.scatter_add_(0, expert, torch.ones_like(expert))
    order = torch.sort(expert, stable=True)[1]
    offsets = F.pad(torch.cumsum(counts[:e], 0), (1, 0))
    weights = torch.rand(pairs, generator=gen, device=device)
    return x, order, offsets, weights, w_in, w_down, counts


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1024, 4096, 14336, 8), (72, 256, 384, 5)],
                         ids=["cell", "small"])
def test_grouped_kernel_against_its_plain_version(cuda, shape):
    t, d, ff, e = shape
    k = 2
    x, order, offsets, weights, w_in, w_down, counts = grouped_inputs(
        cuda, t, d, ff, e, k, 11)
    assert counts[0] == 0 and counts[1] == 1 and counts[e] > 0
    n0 = grouped_mod.moe_grouped.launches
    got = ops.moe_grouped_op(x, order, offsets, weights, k, w_in, w_down)
    torch.cuda.synchronize()
    assert grouped_mod.moe_grouped.launches == n0 + 2
    want = moe_grouped_ref(x, order, offsets, weights, k, w_in, w_down)
    held = torch.zeros(t * k, dtype=torch.bool, device=cuda)
    held[order[:offsets[-1]]] = True
    assert got[~held].abs().max() == 0
    # by pair: held, and whether its token is a padded (all-zero) one
    padded = (x == 0).all(-1).repeat_interleave(k)[held]
    assert padded.any() and not padded.all()
    g, w = got[held].double(), want[held].double()
    assert g[padded].abs().max() == 0
    # float32 sums in another order; h's bf16 rounding may fall the other
    # way for a few of its elements
    g, w = g[~padded], w[~padded]
    scale = w.pow(2).mean(-1, keepdim=True).sqrt()
    rel = (g - w).pow(2).mean(-1, keepdim=True).sqrt() / scale
    assert rel.max() < 1e-2, rel.max()


@pytest.mark.cuda
def test_the_layer_makes_no_sync(cuda):
    cfg = dataclasses.replace(
        get_config("jamba_v0_1_52b"), d_model=256, d_ff=384, num_heads=2,
        num_kv_heads=1, head_dim=128, moe_experts_held=8, moe_dropless=True,
        moe_renormalize=False, attn_impl="pallas", param_dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = moe.init_moe(gen, cfg, torch.bfloat16)
    x = torch.randn((8, 128, 256), generator=gen, device=cuda).bfloat16()
    with torch.no_grad():
        warm, _, _ = moe.moe_block(p, x, cfg)          # builds and loads
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, _, _ = moe.moe_block(p, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.testing.assert_close(out, warm, rtol=0, atol=0)


@pytest.mark.cuda
def test_the_kernel_refuses_a_differentiable_call(cuda):
    x, order, offsets, weights, w_in, w_down, _ = grouped_inputs(
        cuda, 64, 256, 256, 4, 2, 3)
    w_in.requires_grad_(True)
    n0 = grouped_mod.moe_grouped.launches
    with pytest.raises(RuntimeError, match="moe_grouped has no backward"):
        ops.moe_grouped_op(x, order, offsets, weights, 2, w_in, w_down)
    assert grouped_mod.moe_grouped.launches == n0


@pytest.mark.cuda
def test_a_traced_forward_on_the_card_reads_its_counts_later(cuda,
                                                             monkeypatch):
    """A whole 8-layer period at small widths under ``"pallas"``: the span
    carries the grouped kernel's 8 launches at once, and ``moe_rows`` and
    ``moe_away`` only once the deferred reads run, equal to the routing's
    own count."""
    cfg = dataclasses.replace(
        get_config("jamba_v0_1_52b"), num_layers=8, d_model=256, d_ff=384,
        num_heads=2, num_kv_heads=1, head_dim=128, vocab_size=512,
        moe_experts_held=8, moe_dropless=True, moe_renormalize=False,
        attn_rope=False, ssm_dt_bc_norms=True, attn_impl="pallas",
        param_dtype="bfloat16", remat=False)
    params = transformer.init_params(
        torch.Generator(device=cuda).manual_seed(0), cfg)
    x = torch.randint(0, 512, (4, 32), device=cuda)
    chosen = []
    route = moe.route

    def recording(*a, **kw):
        out = route(*a, **kw)
        chosen.append(out[2])
        return out

    monkeypatch.setattr(moe, "route", recording)
    wall = Tracer("full", wall=True)
    with torch.no_grad(), obs_tracer.activated(wall):
        transformer.forward(params, x, cfg)
    (fwd,) = wall.events
    assert fwd.attrs["moe_launches"] == 8
    assert "moe_rows" not in fwd.attrs
    wall.read_device_times(wait=True)
    rows = sum(int((c < 8).sum()) for c in chosen)
    assert (fwd.attrs["moe_rows"], fwd.attrs["moe_away"]) == (
        rows, 4 * 128 * 2 - rows)
    assert fwd.attrs["device_us"] > 0
