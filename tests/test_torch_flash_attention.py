"""The port's flash attention against the JAX package's.

On the CPU the port's ``flash_attention_ref`` is held against the Pallas
``flash_attention`` (interpret mode, as ``tests/test_kernels.py`` runs it)
and against ``repro.kernels.ref.flash_attention_ref``, on the sweeps of that
file: MHA, GQA groups 2 and 4, MQA with a cached prefix (T > S), head_dim
128, sliding windows 32/64/128, non-causal, and S not a multiple of the
block. Inputs come from numpy seeds. Tolerances: fp32 2e-5 (the Pallas
kernel scales q before the dot, the references divide the scores), bf16
2e-2 (the output is rounded to bf16), as in ``tests/test_kernels.py``.

The tests marked ``cuda`` hold the hand-written kernel against its plain
version on the card and skip without one. They need no JAX, which the
card's machine does not have: there, run
``python -m pytest -q -m cuda tests/test_torch_flash_attention.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_inputs(seed, b, h, hkv, s, t, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, t, d)).astype(np.float32),
            rng.standard_normal((b, hkv, t, d)).astype(np.float32))


def check(seed, b, h, hkv, s, t, d, *, dtype="float32", causal=True,
          window=0, block=128):
    """The port's plain version against the Pallas kernel (interpret mode)
    and the reference's oracle, on the same numbers."""
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention as jax_kernel

    arrays = make_inputs(seed, b, h, hkv, s, t, d)
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(TORCH_DTYPES[dtype])
                  for a in arrays)
    got = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == (b, h, s, d)
    got = got.float().numpy()
    tol = TOL[dtype]
    for want in (jax_kernel(jq, jk, jv, causal=causal, window=window,
                            block_q=block, block_k=block, interpret=True),
                 jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                          window=window)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,s,t,d", [
    (1, 4, 4, 128, 128, 64),     # MHA, square
    (2, 4, 2, 128, 128, 64),     # GQA group 2
    (1, 8, 2, 256, 256, 64),     # GQA group 4, two q blocks
    (1, 4, 1, 128, 256, 64),     # MQA, cached prefix (t > s)
    (2, 4, 4, 128, 128, 128),    # head_dim 128
])
def test_causal_sweep(b, h, hkv, s, t, d, dtype):
    check(b * 100 + h * 10 + hkv + s, b, h, hkv, s, t, d, dtype=dtype)


@pytest.mark.parametrize("window", [32, 64, 128])
def test_sliding_window(window):
    check(window, 1, 4, 4, 256, 256, 64, window=window)


def test_noncausal():
    check(3, 1, 2, 2, 128, 128, 64, causal=False)


@pytest.mark.parametrize("s,t,window", [(100, 100, 0), (70, 150, 0),
                                        (100, 100, 40)])
def test_sequence_not_a_multiple_of_the_block(s, t, window):
    check(s + t, 2, 4, 2, s, t, 32, window=window, block=64)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    q, k, v = (torch.from_numpy(a) for a in make_inputs(0, 1, 4, 2, 8, 8, 32))
    before = fa.flash_attention.launches
    out = ops.flash_attention_op(q, k, v, window=3)
    torch.testing.assert_close(
        out, flash_attention_ref(q, k, v, window=3), rtol=0, atol=0)
    assert fa.flash_attention.launches == before


def test_neither_cpu_nor_cuda_raises():
    q = torch.empty((1, 4, 8, 64), device="meta")
    k = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention(q, k, k)


@pytest.mark.parametrize("s,d,dtype,want", [
    (4096, 128, torch.bfloat16, "wgmma"),   # starcoder2-3b prefill
    (4096, 64, torch.bfloat16, "wgmma"),
    (fa.WGMMA_MIN_SEQ, 128, torch.bfloat16, "wgmma"),
    (fa.WGMMA_MIN_SEQ - 1, 128, torch.bfloat16, "mma"),
    (16, 128, torch.bfloat16, "mma"),       # the LM router's prompts
    (4096, 96, torch.bfloat16, "mma"),      # D 96 and 32 are not whole boxes
    (4096, 32, torch.bfloat16, "mma"),
    (4096, 128, torch.float32, "f32"),
    (1, 32, torch.float32, "f32"),
])
def test_route_by_shape(s, d, dtype, want):
    assert fa.route(s, d, dtype) == want


def test_every_route_names_a_kernel_of_the_source():
    assert set(fa.ROUTES) == {"f32", "mma", "wgmma"}
    assert fa.WGMMA_HEAD_DIMS == (64, 128)
    assert set(fa.flash_attention.routes) == set(fa.ROUTES)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,s,t,d,causal,window", [
    (1, 4, 4, 128, 128, 64, True, 0),
    (2, 8, 2, 200, 200, 32, True, 0),       # ragged S, group 4, D 32
    (1, 6, 2, 64, 300, 96, True, 0),        # cached prefix, D 96
    (2, 24, 2, 333, 517, 128, True, 0),     # ragged, T > S, starcoder2 heads
    (1, 4, 1, 256, 256, 128, True, 50),     # window inside a tile
    (1, 4, 2, 300, 300, 64, True, 128),     # window on tile edges
    (1, 4, 4, 130, 130, 64, False, 0),      # non-causal
    (1, 2, 2, 70, 190, 32, False, 33),      # non-causal with a window
    (1, 2, 1, 1, 1, 32, True, 0),           # one token
])
def test_kernel_matches_plain_version(cuda, dtype, b, h, hkv, s, t, d,
                                      causal, window):
    q, k, v = (torch.from_numpy(a).to(cuda, TORCH_DTYPES[dtype])
               for a in make_inputs(s + t + d, b, h, hkv, s, t, d))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = TOL[dtype]
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_kernel_reads_transposed_views(cuda):
    """The transformer hands the kernel [B,S,H,D] tensors transposed to
    [B,H,S,D]; the result transposed back is contiguous."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 100, 8, 64))).to(
        cuda, torch.bfloat16)
    kv = torch.from_numpy(rng.standard_normal((2, 100, 2, 64))).to(
        cuda, torch.bfloat16)
    got = fa.flash_attention(q.transpose(1, 2), kv.transpose(1, 2),
                             kv.transpose(1, 2))
    assert got.transpose(1, 2).is_contiguous()
    want = flash_attention_ref(q.transpose(1, 2).contiguous(),
                               kv.transpose(1, 2).contiguous(),
                               kv.transpose(1, 2).contiguous())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_kernel_at_the_lm_router_batches(cuda, b):
    """The LM router's forwards at StarCoder2-3B's width: bf16, 24/2 heads
    of 128, 16-token prompts (one partial q tile, one key tile mostly past
    T), handed over as transposed views."""
    rng = np.random.default_rng(b)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, 16, h, 128))).to(
        cuda, torch.bfloat16).transpose(1, 2) for h in (24, 2, 2))
    got = fa.flash_attention(q, k, v)
    want = flash_attention_ref(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_cuda_path_never_calls_the_plain_version(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(fa, "flash_attention_ref", refuse)
    q, k, v = (torch.from_numpy(a).to(cuda)
               for a in make_inputs(1, 1, 4, 2, 64, 64, 64))
    out = ops.flash_attention_op(q, k, v)
    torch.cuda.synchronize()
    assert out.is_cuda and torch.isfinite(out).all()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 4, 16, 48), device=cuda)
    k = torch.zeros((1, 2, 16, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, k, k)
    q = torch.zeros((1, 4, 16, 64), device=cuda)
    k = torch.zeros((1, 2, 16, 64), device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="T >= S"):
        fa.flash_attention(q, k[:, :, :8], k[:, :, :8])
    strided_q = torch.zeros((1, 4, 64, 16), device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        fa.flash_attention(strided_q, k, k)


def draw(rng, b, h, s, d, layout, device):
    """A bf16 [B,H,S,D] tensor, or a [B,H,S,D] view of a [B,S,H,D] one."""
    if layout == "bshd":
        x = torch.from_numpy(rng.standard_normal((b, s, h, d)))
        return x.to(device, torch.bfloat16).transpose(1, 2)
    return torch.from_numpy(rng.standard_normal((b, h, s, d))).to(
        device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("b,h,hkv,s,t,d,causal,window", [
    (1, 6, 2, 200, 200, 128, True, 0),      # S = T, not a multiple of 128
    (1, 6, 2, 200, 201, 128, True, 0),      # T - S = 1
    (1, 6, 2, 200, 327, 128, True, 0),      # T - S = 127
    (2, 12, 4, 385, 385, 64, True, 0),      # group 3, D 64, ragged q tile
    (1, 24, 2, 300, 428, 128, True, 0),     # group 12, T - S = 128
    (1, 4, 1, 256, 256, 128, True, 50),     # window edge inside a key tile
    (1, 4, 2, 520, 600, 64, True, 200),     # window edge, T > S, D 64
    (1, 4, 4, 140, 270, 128, False, 0),     # non-causal, ragged T
    (1, 2, 2, 300, 300, 64, False, 77),     # non-causal with a window
])
def test_wgmma_kernel_matches_plain_version(cuda, layout, b, h, hkv, s, t, d,
                                            causal, window):
    rng = np.random.default_rng(s + t + d + window)
    q = draw(rng, b, h, s, d, layout, cuda)
    k, v = (draw(rng, b, hkv, t, d, layout, cuda) for _ in range(2))
    before = dict(fa.flash_attention.routes)
    got = fa.launch(q, k, v, causal=causal, window=window, kernel="wgmma")
    torch.cuda.synchronize()
    assert fa.flash_attention.routes["wgmma"] == before["wgmma"] + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("side", [-1, 0])
def test_both_sides_of_the_crossover(cuda, d, side):
    """Around WGMMA_MIN_SEQ the dispatching wrapper takes the kernel the
    rule names, and both bf16 kernels agree with the plain version."""
    s = fa.WGMMA_MIN_SEQ + side
    rng = np.random.default_rng(s + d)
    q = draw(rng, 1, 24, s, d, "bshd", cuda)
    k, v = (draw(rng, 1, 2, s, d, "bshd", cuda) for _ in range(2))
    want = flash_attention_ref(q, k, v)
    before = dict(fa.flash_attention.routes)
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    picked = fa.route(s, d, torch.bfloat16)
    assert picked == ("wgmma" if side == 0 else "mma")
    assert fa.flash_attention.routes[picked] == before[picked] + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    for kernel in ("mma", "wgmma"):
        other = fa.launch(q, k, v, causal=True, window=0, kernel=kernel)
        torch.testing.assert_close(other.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.cuda
def test_wgmma_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 4, 256, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not take"):
        fa.launch(q, q, q, causal=True, window=0, kernel="wgmma")
    with pytest.raises(ValueError, match="does not take"):
        fa.launch(q.float(), q.float(), q.float(), causal=True, window=0,
                  kernel="mma")


# --------------------------------------------------------------------------- #
# no backward: every kernel entry point refuses a differentiable call
# --------------------------------------------------------------------------- #

def op_calls(device):
    """Each kernel entry point with small inputs on ``device``: (name,
    inputs, call)."""
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(device)

    return [
        ("flash_attention", [t(1, 2, 8, 32), t(1, 1, 8, 32), t(1, 1, 8, 32)],
         lambda q, k, v: ops.flash_attention_op(q, k, v)),
        ("decode_attention", [t(1, 2, 32), t(1, 1, 16, 32), t(1, 1, 16, 32)],
         lambda q, k, v: ops.decode_attention_op(q, k, v, 5)),
        ("mamba_scan", [t(1, 8, 16), t(1, 8, 16).abs() * 0.1, t(1, 8, 4),
                        t(1, 8, 4), -t(16, 4).abs(), t(16)],
         ops.mamba_scan_op),
    ]


def check_refusal(device):
    for name, inputs, call in op_calls(device):
        for i in range(len(inputs)):
            args = [a.clone().requires_grad_(j == i)
                    for j, a in enumerate(inputs)]
            with pytest.raises(RuntimeError, match=f"{name} has no backward"):
                call(*args)
            with torch.no_grad():
                call(*args)                     # serving: no error
        call(*inputs)                           # nothing requires grad


def test_ops_refuse_a_differentiable_call_on_the_cpu():
    """On the CPU the plain versions would differentiate, but the entry
    points refuse as they do on the card, so that a CPU run cannot train
    what the card would not."""
    check_refusal(torch.device("cpu"))


def test_attention_block_with_pallas_refuses_to_train():
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import layers

    cfg = smoke_config(get_config("starcoder2_3b"))
    gen = torch.Generator().manual_seed(0)
    params = layers.init_attention(gen, cfg, torch.float32)
    params = {k: v.requires_grad_() for k, v in params.items()}
    x = torch.randn(1, 8, cfg.d_model, generator=gen)
    for impl, raises in (("pallas", True), ("xla", False)):
        c = dataclasses.replace(cfg, attn_impl=impl)
        if raises:
            with pytest.raises(RuntimeError, match="attn_impl=\"xla\""):
                layers.attention_block(params, x, c, None,
                                       compute_dtype=torch.float32)
        else:
            out, _ = layers.attention_block(params, x, c, None,
                                            compute_dtype=torch.float32)
            out.sum().backward()
            assert params["wq"].grad is not None


@pytest.mark.cuda
def test_ops_refuse_a_differentiable_call_on_the_card(cuda):
    check_refusal(cuda)
    torch.cuda.synchronize()
