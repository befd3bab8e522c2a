"""The port's decode attention against the JAX package's.

On the CPU the port's ``decode_attention_ref`` is held against the Pallas
``decode_attention`` (interpret mode, as ``tests/test_decode_kernels.py``
runs it) and against ``repro.kernels.ref.decode_attention_ref``, on the
sweeps of that file: wrap-around past 3x the ring width, sliding windows,
GQA/MQA group sizes, and fp32, bf16 and fp32-q with bf16-kv. Inputs come
from numpy seeds. Tolerances: fp32 2e-5 (the Pallas kernel scales q before
the dot, the references divide the scores, so the roundings differ), bf16
2e-2 (the output is rounded to bf16).

The tests marked ``cuda`` hold the hand-written kernel against its plain
version on the card and skip without one. They need no JAX, which the
card's machine does not have: there, run
``python -m pytest -q -m cuda tests/test_torch_decode_attention.py``.
The JAX package is imported inside the CPU-side helpers for that reason.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.kernels.ref import decode_attention_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_inputs(seed, b, h, hkv, w, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, w, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, w, d)).astype(np.float32)
    return q, k, v


def as_torch(q, k, v, q_dtype, kv_dtype):
    return (torch.from_numpy(q).to(TORCH_DTYPES[q_dtype]),
            torch.from_numpy(k).to(TORCH_DTYPES[kv_dtype]),
            torch.from_numpy(v).to(TORCH_DTYPES[kv_dtype]))


def check(seed, b, h, hkv, w, d, pos, window=0, q_dtype="float32",
          kv_dtype="float32"):
    """The port's plain version against the Pallas kernel (interpret mode)
    and the reference's oracle, on the same numbers (both packages round
    float32 -> bfloat16 to nearest even)."""
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import decode_attention as jax_kernel

    q, k, v = make_inputs(seed, b, h, hkv, w, d)
    jq = jnp.asarray(q).astype(getattr(jnp, q_dtype))
    jk = jnp.asarray(k).astype(getattr(jnp, kv_dtype))
    jv = jnp.asarray(v).astype(getattr(jnp, kv_dtype))
    tq, tk, tv = as_torch(q, k, v, q_dtype, kv_dtype)
    got = decode_attention_ref(tq, tk, tv, pos, window=window)
    assert got.dtype == tq.dtype and got.shape == (b, h, d)
    got = got.float().numpy()
    tol = TOL[q_dtype]
    for want in (jax_kernel(jq, jk, jv, pos, window=window, interpret=True),
                 jref.decode_attention_ref(jq, jk, jv, pos, window=window)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("pos", [0, 31, 32, 63, 64, 97, 200])
def test_wraparound(pos):
    check(pos, 1, 4, 2, 32, 64, pos)


@pytest.mark.parametrize("window", [8, 16, 31])
@pytest.mark.parametrize("pos", [40, 64, 150])
def test_sliding_window_under_wraparound(window, pos):
    check(7 * pos + window, 1, 4, 2, 32, 64, pos, window=window)


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (8, 2), (4, 1), (16, 4)])
def test_gqa_group_sizes_wrapped(h, hkv):
    check(h * 10 + hkv, 1, h, hkv, 32, 64, 50)


@pytest.mark.parametrize("q_dtype,kv_dtype", [("float32", "float32"),
                                              ("bfloat16", "bfloat16"),
                                              ("float32", "bfloat16")])
@pytest.mark.parametrize("pos", [5, 70])
def test_dtypes_batched(q_dtype, kv_dtype, pos):
    check(pos, 2, 8, 2, 32, 64, pos, window=0, q_dtype=q_dtype,
          kv_dtype=kv_dtype)


def test_no_valid_slot_averages_v_like_the_reference():
    """pos < 0 masks every slot with -1e30 (not -inf): the row averages v
    in both packages instead of turning into NaN."""
    check(3, 1, 4, 2, 16, 64, -1)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    q, k, v = make_inputs(0, 1, 4, 2, 16, 64)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = da.decode_attention.launches
    out = ops.decode_attention_op(tq, tk, tv, 20, window=8)
    torch.testing.assert_close(
        out, decode_attention_ref(tq, tk, tv, 20, window=8), rtol=0, atol=0)
    assert da.decode_attention.launches == before


def test_neither_cpu_nor_cuda_raises():
    q = torch.empty((1, 4, 64), device="meta")
    k = torch.empty((1, 2, 16, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        da.decode_attention(q, k, k, 3)


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(da.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        da.find_nvcc()


def test_library_is_keyed_by_its_source():
    path = da.library_path()
    assert path.parent == da.BUILD_DIR and path.suffix == ".so"
    assert path == da.library_path()


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [("float32", "float32"),
                                              ("bfloat16", "bfloat16"),
                                              ("float32", "bfloat16")])
@pytest.mark.parametrize("h,hkv,w,d,window", [(4, 2, 64, 64, 0),
                                              (24, 8, 512, 128, 0),
                                              (24, 2, 512, 128, 100),
                                              (8, 1, 100, 256, 0)])
@pytest.mark.parametrize("pos", [0, 63, 64, 1553])
def test_kernel_matches_plain_version(cuda, q_dtype, kv_dtype, h, hkv, w, d,
                                      window, pos):
    q, k, v = make_inputs(pos + w, 2, h, hkv, w, d)
    tq, tk, tv = (t.to(cuda) for t in as_torch(q, k, v, q_dtype, kv_dtype))
    before = da.decode_attention.launches
    got = da.decode_attention(tq, tk, tv, pos, window=window)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    want = decode_attention_ref(tq, tk, tv, pos, window=window)
    tol = TOL[q_dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_path_never_calls_the_plain_version(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(da, "decode_attention_ref", refuse)
    q, k, v = make_inputs(1, 1, 4, 2, 64, 64)
    out = ops.decode_attention_op(*(torch.from_numpy(a).to(cuda)
                                    for a in (q, k, v)), 70)
    torch.cuda.synchronize()
    assert out.is_cuda and torch.isfinite(out).all()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 4, 48), device=cuda)
    k = torch.zeros((1, 2, 16, 48), device=cuda)
    with pytest.raises(ValueError, match="multiple of 32"):
        da.decode_attention(q, k, k, 3)
    with pytest.raises(TypeError):
        da.decode_attention(q.half(), k.half(), k.half(), 3)
