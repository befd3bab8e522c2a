"""The norm and RoPE kernels' entry points (``kernels/add_norm.py``,
``kernels/rope.py``) and their place in the model step.

On the CPU (no JAX here): each plain version is, bit for bit, the chain the
model ran before the kernels; a forward under ``attn_impl="pallas"`` equals
one under ``"xla"`` bit for bit where attention and the scan take the same
functions; M-RoPE and ``"xla"`` (a grad call among them) keep the plain
chains; the ops, and so ``"pallas"``, refuse a differentiable call; a
wall-traced forward counts the launches.

Marked ``cuda`` (skip without a card): each kernel against its plain chain
at the benchmark cells' shapes, a ragged width and a decode step; the
launches of a 2-layer StarCoder2 forward; the profiler's kernels a layer.

    python -m pytest -q -m cuda tests/test_torch_norm_rope.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import add_norm as add_norm_mod
from repro_torch.kernels import ops
from repro_torch.kernels import rope as rope_mod
from repro_torch.kernels.ref import add_norm_ref, rope_ref
from repro_torch.launch import lm_coe_router as lm
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer
from repro_torch.obs import Tracer
from repro_torch.obs import tracer as obs_tracer

THETA = 999999.4420358813          # StarCoder2-3B's rope_theta


# the chains the model ran before the kernels, as they were written
def chain_rmsnorm(x, scale, eps=1e-5):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * scale.float()
    return out.to(dtype)


def chain_layernorm(x, scale, bias, eps=1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(dtype)


def chain_rope(x, positions, theta):
    b, s, h, hd = x.shape
    half = hd // 2
    freqs = torch.from_numpy(L.rope_frequencies(hd, theta)).to(x.device)
    angles = positions.float()[..., None] * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rand(gen, *shape, dtype=torch.float32, device="cpu", scale=1.0):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def bitwise(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.contiguous().view(BITS[a.dtype]),
                       b.contiguous().view(BITS[b.dtype]))


def norm_inputs(gen, shape, dtype, pdtype, device="cpu"):
    d = shape[-1]
    return (rand(gen, *shape, dtype=dtype, device=device),
            rand(gen, *shape, dtype=dtype, device=device, scale=0.5),
            rand(gen, d, dtype=pdtype, device=device, scale=0.2) + 1,
            rand(gen, d, dtype=pdtype, device=device, scale=0.2))


# --------------------------------------------------------------------------- #
# the plain versions are the chains
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype,pdtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)], ids=["bf16", "bf16-f32-params", "f32"])
@pytest.mark.parametrize("norm_type", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("with_delta", [False, True],
                         ids=["no-delta", "delta"])
def test_plain_norm_is_the_chain_bit_for_bit(dtype, pdtype, norm_type,
                                             with_delta):
    gen = torch.Generator().manual_seed(0)
    x, delta, scale, bias = norm_inputs(gen, (2, 7, 96), dtype, pdtype)
    delta = delta if with_delta else None
    s = x if delta is None else x + delta
    want = (chain_layernorm(s, scale, bias, 1e-5) if norm_type == "layernorm"
            else chain_rmsnorm(s, scale, 1e-5))
    for fn in (add_norm_ref, add_norm_mod.add_norm, ops.add_norm_op):
        got_s, got = fn(x, scale, bias if norm_type == "layernorm" else None,
                        delta, norm_type=norm_type, eps=1e-5)
        bitwise(got_s, s)
        bitwise(got, want)
    params = {"scale": scale, "bias": bias}
    bitwise(L.add_apply_norm(x, delta, params, norm_type, 1e-5,
                             "pallas")[1], want)
    if delta is None:
        bitwise(L.apply_norm(x, params, norm_type, 1e-5, "pallas"), want)
        bitwise(L.apply_norm(x, params, norm_type, 1e-5), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("positions", ["expanded", "offset", "strided"])
def test_plain_rope_is_the_chain_bit_for_bit(dtype, positions):
    gen = torch.Generator().manual_seed(1)
    b, s, hd = 3, 5, 32
    q = rand(gen, b, s, 4, hd, dtype=dtype)
    k = rand(gen, b, s, 2, hd, dtype=dtype)
    if positions == "expanded":             # transformer._default_positions
        pos = torch.arange(s)[None, :].expand(b, s)
    elif positions == "offset":             # a decode step's, at 4095
        pos = (4095 + torch.arange(s))[None, :].expand(b, s)
    else:
        pos = torch.randint(0, 4096, (b, 2 * s), generator=gen)[:, ::2]
    freqs = L._rope_table(hd, THETA, (), q.device)
    want_q, want_k = chain_rope(q, pos, THETA), chain_rope(k, pos, THETA)
    for fn in (rope_ref, rope_mod.rope, ops.rope_op):
        got_q, got_k = fn(q, k, pos, freqs)
        bitwise(got_q, want_q)
        bitwise(got_k, want_k)
    for impl in ("xla", "pallas"):
        got_q, got_k = L.apply_rope_qk(q, k, pos, THETA, (), impl)
        bitwise(got_q, want_q)
        bitwise(got_k, want_k)


# --------------------------------------------------------------------------- #
# the model step
# --------------------------------------------------------------------------- #

def counted(monkeypatch):
    """Count the calls of the kernels' entry points from the model, in each
    wrapper's ``launches`` (on the CPU the wrappers run their plain versions
    and count nothing)."""
    for mod, name, fn in ((ops, "add_norm", add_norm_mod.add_norm),
                          (ops, "rope", rope_mod.rope)):
        def call(*a, _fn=fn, **kw):
            _fn.launches += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, call)


def same_mixers(monkeypatch, cfg):
    """Attention and the scan on ``"pallas"`` take the functions ``"xla"``
    runs, so that a forward under either differs only in the norms and
    RoPE."""
    def flash(q, k, v, *, causal=True, window=0):
        return L.chunked_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window,
            chunk=cfg.attn_chunk).transpose(1, 2)

    def scan(x, dt, b_mat, c_mat, a, d_vec):
        return ssm_lib.chunked_scan(x, dt, b_mat, c_mat, a, d_vec,
                                    cfg.ssm_chunk)

    monkeypatch.setattr(L, "flash_attention_op", flash)
    monkeypatch.setattr(ssm_lib, "mamba_scan_op", scan)


# (arch, norm launches, rope launches) of a 2-layer forward
FORWARDS = [("starcoder2_3b", 5, 2), ("falcon_mamba_7b", 3, 0)]


@pytest.mark.parametrize("arch,norms,ropes", FORWARDS)
def test_pallas_forward_on_the_cpu_equals_xla_bit_for_bit(monkeypatch, arch,
                                                          norms, ropes):
    cfg = lm.lm_config("smoke", 2, arch)          # attn_impl "pallas"
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.randint(0, cfg.vocab_size, (2, 16),
                      generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = transformer.forward(
            params, x, dataclasses.replace(cfg, attn_impl="xla"))
        same_mixers(monkeypatch, cfg)
        counted(monkeypatch)
        n0, r0 = add_norm_mod.add_norm.launches, rope_mod.rope.launches
        got, _ = transformer.forward(params, x, cfg)
    assert (add_norm_mod.add_norm.launches - n0,
            rope_mod.rope.launches - r0) == (norms, ropes)
    bitwise(got, want)


@pytest.mark.parametrize("arch,norms,ropes", FORWARDS)
def test_a_wall_traced_forward_counts_the_launches(monkeypatch, arch, norms,
                                                   ropes):
    cfg = lm.lm_config("smoke", 2, arch)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.zeros((2, 8), dtype=torch.int32)
    counted(monkeypatch)
    wall = Tracer("full", wall=True)
    with torch.no_grad(), obs_tracer.activated(wall):
        transformer.forward(params, x, cfg)
        transformer.forward(params, x, dataclasses.replace(
            cfg, attn_impl="xla"))
    pallas, xla = wall.events
    assert pallas.attrs == {"tokens": 16, "norm_launches": norms,
                            "rope_launches": ropes, "moe_launches": 0}
    assert xla.attrs == {"tokens": 16, "norm_launches": 0,
                         "rope_launches": 0, "moe_launches": 0}


def refused(name):
    def call(*a, **kw):
        raise AssertionError(f"{name} was called")
    return call


def test_mrope_xla_and_grad_take_the_plain_chains(monkeypatch):
    monkeypatch.setattr(L, "rope_op", refused("rope_op"))
    # M-RoPE under "pallas": the norms through their entry point, RoPE plain
    cfg = dataclasses.replace(smoke_config(get_config("qwen2_vl_2b")),
                              num_layers=1, attn_impl="pallas")
    assert cfg.mrope_sections
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.zeros((1, 8), dtype=torch.int32)
    counted(monkeypatch)
    n0 = add_norm_mod.add_norm.launches
    with torch.no_grad():
        transformer.forward(params, x, cfg)
        assert add_norm_mod.add_norm.launches - n0 == 3
        # "xla": neither entry point
        monkeypatch.setattr(L, "add_norm_op", refused("add_norm_op"))
        transformer.forward(params, x, dataclasses.replace(
            cfg, attn_impl="xla"))
    # a call that needs grad: under "xla" the plain chains, and a gradient
    # flows back through them; under "pallas" the ops refuse it, as the
    # attention kernels do
    monkeypatch.undo()
    gen = torch.Generator().manual_seed(2)
    h = rand(gen, 2, 4, 64).requires_grad_()
    delta = rand(gen, 2, 4, 64)
    p = {"scale": torch.ones(64), "bias": torch.zeros(64)}
    q = rand(gen, 2, 4, 4, 32).requires_grad_()
    k = rand(gen, 2, 4, 2, 32)
    pos = torch.arange(4)[None].expand(2, 4)
    with pytest.raises(RuntimeError, match="no backward"):
        L.add_apply_norm(h, delta, p, "layernorm", 1e-5, "pallas")
    with pytest.raises(RuntimeError, match="no backward"):
        L.apply_rope_qk(q, k, pos, 1e4, (), "pallas")
    s, out = L.add_apply_norm(h, delta, p, "layernorm", 1e-5, "xla")
    rq, rk = L.apply_rope_qk(q, k, pos, 1e4, (), "xla")
    (out.sum() + s.sum() + rq.sum() + rk.sum()).backward()
    assert h.grad is not None and q.grad is not None


@pytest.mark.parametrize("op", ["add_norm_op", "rope_op"])
def test_the_ops_refuse_a_differentiable_call(op):
    gen = torch.Generator().manual_seed(3)
    if op == "add_norm_op":
        x = rand(gen, 2, 3, 16).requires_grad_()
        args, kw = (x, torch.ones(16)), dict(norm_type="rmsnorm", eps=1e-5)
    else:
        x = rand(gen, 1, 2, 2, 16).requires_grad_()
        args, kw = (x, x.detach(), torch.zeros((1, 2), dtype=torch.long),
                    torch.ones(8)), {}
    with pytest.raises(RuntimeError, match="no backward"):
        getattr(ops, op)(*args, **kw)
    with torch.no_grad():
        getattr(ops, op)(*args, **kw)


def test_the_kernels_take_only_cuda_tensors_off_the_cpu():
    x = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        add_norm_mod.add_norm(x, torch.empty(64, device="meta"),
                              norm_type="rmsnorm", eps=1e-5)
    q = torch.empty((1, 2, 2, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rope_mod.rope(q, q, torch.empty((1, 2), dtype=torch.long,
                                        device="meta"),
                      torch.empty(16, device="meta"))


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def ordered(t):
    """Each value's place in the order of its dtype's values (one step a
    unit in the last place; +0 and -0 both 0)."""
    i = t.contiguous().view(BITS[t.dtype]).long()
    mag = i & (0x7FFF if t.dtype == torch.bfloat16 else 0x7FFFFFFF)
    return torch.where(i < 0, -mag, mag)


def within_one_ulp(got, want, rows_rms):
    """Each value within one unit in the last place of the chain's, or
    within 1e-6 of its row's RMS: two float32 sums of one row in two orders
    differ by a few float32 roundings of the row's scale, which moves a
    result near zero (a cancellation) by more than its own last place."""
    ulps = (ordered(got) - ordered(want)).abs()
    gap = (got.float() - want.float()).abs()
    ok = (ulps <= 1) | (gap <= 1e-6 * rows_rms)
    return bool(ok.all()), int(ulps.max()), float(ok.logical_not().sum())


def f64_norm(x, delta, scale, bias, norm_type, eps):
    s = x if delta is None else (x.float() + delta.float()).to(x.dtype)
    s = s.double()
    if norm_type == "layernorm":
        mu = s.mean(-1, keepdim=True)
        var = ((s - mu) ** 2).mean(-1, keepdim=True)
        return (s - mu) / torch.sqrt(var + eps) * scale.double() \
            + bias.double()
    return s / torch.sqrt((s * s).mean(-1, keepdim=True) + eps) \
        * scale.double()


# (label, shape, norm type, with delta, dtype, param dtype)
NORM_CASES = [
    ("sc2 layernorm + delta", (8, 128, 3072), "layernorm", True,
     torch.bfloat16, torch.bfloat16),
    ("fm rmsnorm", (8, 128, 4096), "rmsnorm", False, torch.bfloat16,
     torch.bfloat16),
    ("ragged d 2560 layernorm", (8, 128, 2560), "layernorm", True,
     torch.bfloat16, torch.float32),
    ("ragged d 2560 rmsnorm + delta", (8, 128, 2560), "rmsnorm", True,
     torch.bfloat16, torch.bfloat16),
    ("decode step S 1", (8, 1, 3072), "layernorm", False, torch.bfloat16,
     torch.bfloat16),
    ("float32 layernorm + delta", (4, 64, 3072), "layernorm", True,
     torch.float32, torch.float32),
    ("wide d 12288 rmsnorm", (4, 8, 12288), "rmsnorm", True, torch.bfloat16,
     torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", NORM_CASES, ids=[c[0] for c in NORM_CASES])
def test_add_norm_kernel_against_the_chain(cuda, case):
    _, shape, norm_type, with_delta, dtype, pdtype = case
    gen = torch.Generator(device=cuda).manual_seed(4)
    x, delta, scale, bias = norm_inputs(gen, shape, dtype, pdtype, cuda)
    delta = delta if with_delta else None
    bias = bias if norm_type == "layernorm" else None
    n0 = add_norm_mod.add_norm.launches
    s, out = ops.add_norm_op(x, scale, bias, delta, norm_type=norm_type,
                             eps=1e-5)
    torch.cuda.synchronize()
    assert add_norm_mod.add_norm.launches == n0 + 1
    want_s, want = add_norm_ref(x, scale, bias, delta, norm_type=norm_type,
                                eps=1e-5)
    bitwise(s, want_s)
    rms = want.float().pow(2).mean(-1, keepdim=True).sqrt()
    ok, max_ulps, off = within_one_ulp(out, want, rms)
    assert ok, (max_ulps, off)
    exact = f64_norm(x, delta, scale, bias, norm_type, 1e-5)
    err = (out.double() - exact).abs().max().item()
    plain = (want.double() - exact).abs().max().item()
    assert err <= plain + 1e-6 * exact.abs().max().item(), (err, plain)


@pytest.mark.cuda
def test_add_norm_kernel_on_the_last_positions(cuda):
    """The head's norm of a prefill takes x[:, -1:], rows a whole sequence
    apart: the kernel reads them in place."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x, _, scale, bias = norm_inputs(gen, (4, 16, 3072), torch.bfloat16,
                                    torch.bfloat16, cuda)
    last = x[:, -1:]
    assert not last.is_contiguous()
    s, out = ops.add_norm_op(last, scale, bias, norm_type="layernorm",
                             eps=1e-5)
    want = add_norm_ref(last.contiguous(), scale, bias,
                        norm_type="layernorm", eps=1e-5)[1]
    torch.cuda.synchronize()
    assert s is last and out.shape == last.shape
    rms = want.float().pow(2).mean(-1, keepdim=True).sqrt()
    ok, max_ulps, off = within_one_ulp(out, want, rms)
    assert ok, (max_ulps, off)


# (label, batch, seq, query heads, kv heads, head dim, first position, dtype)
ROPE_CASES = [
    ("sc2 prefill", 8, 128, 24, 2, 128, 0, torch.bfloat16),
    ("decode step at 4095", 8, 1, 24, 2, 128, 4095, torch.bfloat16),
    ("head dim 64, float32", 2, 100, 16, 16, 64, 7, torch.float32),
    ("head dim 96", 2, 33, 8, 8, 96, 0, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROPE_CASES, ids=[c[0] for c in ROPE_CASES])
def test_rope_kernel_against_the_chain(cuda, case):
    _, b, s, hq, hkv, hd, first, dtype = case
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = rand(gen, b, s, hq, hd, dtype=dtype, device=cuda)
    k = rand(gen, b, s, hkv, hd, dtype=dtype, device=cuda)
    pos = (first + torch.arange(s, device=cuda))[None].expand(b, s)
    freqs = L._rope_table(hd, THETA, (), cuda)
    want_q, want_k = rope_ref(q, k, pos, freqs)
    n0 = rope_mod.rope.launches
    got_q, got_k = ops.rope_op(q.clone(), k.clone(), pos, freqs)
    torch.cuda.synchronize()
    assert rope_mod.rope.launches == n0 + 1
    angles = pos.double()[..., None] * freqs.double()
    for got, want, x in ((got_q, want_q, q), (got_k, want_k, k)):
        rms = want.float().pow(2).mean(-1, keepdim=True).sqrt()
        ok, max_ulps, off = within_one_ulp(got, want, rms)
        assert ok, (max_ulps, off)
        half = hd // 2
        cos = torch.cos(angles)[:, :, None]
        sin = torch.sin(angles)[:, :, None]
        x1, x2 = x[..., :half].double(), x[..., half:].double()
        exact = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
        err = (got.double() - exact).abs().max().item()
        plain = (want.double() - exact).abs().max().item()
        assert err <= plain + 1e-6 * exact.abs().max().item(), (err, plain)


def sc2(layers: int):
    """StarCoder2-3B at its width, ``layers`` deep, bf16 weights (as the
    benchmark serves it)."""
    return dataclasses.replace(lm.lm_config("full", layers, "starcoder2_3b"),
                               param_dtype="bfloat16", rope_theta=THETA)


@pytest.mark.cuda
def test_a_two_layer_starcoder2_forward_launches_each_kernel(cuda,
                                                            monkeypatch):
    cfg = sc2(2)
    params = transformer.init_params(
        torch.Generator(device=cuda).manual_seed(0), cfg)
    x = torch.randint(0, cfg.vocab_size, (4, 128), device=cuda)
    wall = Tracer("full", wall=True)
    with torch.no_grad():
        transformer.forward(params, x, cfg)
        n0, r0 = add_norm_mod.add_norm.launches, rope_mod.rope.launches
        with obs_tracer.activated(wall):
            got, _ = transformer.forward(params, x, cfg)
        assert (add_norm_mod.add_norm.launches - n0,
                rope_mod.rope.launches - r0) == (5, 2)
        # the same forward with the plain chains in the kernels' place
        monkeypatch.setattr(L, "add_norm_op", add_norm_ref)
        monkeypatch.setattr(L, "rope_op", rope_ref)
        want, _ = transformer.forward(params, x, cfg)
    (fwd,) = [e for e in wall.events if e.name == "forward"]
    assert (fwd.attrs["norm_launches"], fwd.attrs["rope_launches"]) == (5, 2)
    # the kernels' roundings against the chains' (a last bit here and
    # there), carried through two layers: the logits agree closely
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    assert rel < 0.01, rel


# One forward of StarCoder2-3B at its width, ``layers`` deep, profiled in
# a process of its own: the profiler's CUPTI state then cannot reach the
# profiler tests of other files that a pytest process runs after this one.
PROFILE_KERNELS = """
import dataclasses, json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.launch import lm_coe_router as lm
from repro_torch.models import transformer

counts = {}
x = torch.randint(0, 49152, (8, 128), device="cuda")
for layers in (2, 4):
    cfg = dataclasses.replace(lm.lm_config("full", layers, "starcoder2_3b"),
                              param_dtype="bfloat16", rope_theta=%r)
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    with torch.no_grad():
        transformer.forward(params, x, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            transformer.forward(params, x, cfg)
            torch.cuda.synchronize()
    counts[layers] = sum(
        1 for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
        and not e.name().startswith(("Memcpy", "Memset")))
    del params
print(json.dumps(counts))
""" % THETA


@pytest.mark.cuda
def test_the_profiler_counts_at_most_13_kernels_a_starcoder2_layer(cuda):
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", PROFILE_KERNELS], cwd=root,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    counts = {int(k): v for k, v in json.loads(
        out.stdout.strip().splitlines()[-1]).items()}
    per_layer = (counts[4] - counts[2]) / 2
    assert 0 < per_layer <= 13, counts
