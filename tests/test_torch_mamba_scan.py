"""The port's selective scan against the JAX package's.

On the CPU the port's ``mamba_scan`` (there: its plain version,
``mamba_scan_ref``) is held against the Pallas ``mamba_scan`` (interpret
mode, as ``tests/test_kernels.py`` runs it) and against
``repro.kernels.ref.mamba_scan_ref``, on the shapes and dtypes of that file:
two sequence chunks, two channel blocks, a narrow state; then the carry over
chunk boundaries, a starting state ``h0``, and sequences that divide no
chunk. Inputs come from numpy seeds, drawn as that file draws them (dt a
softplus, A negative). Tolerances as in ``tests/test_kernels.py``: float32
2e-5 (exp and the sum over N in another order), bfloat16 2e-2 (y rounded to
bf16. ``tests/test_torch_mamba_chunked.py`` holds the chunked kernel's
order of operations and ``plan`` on the CPU.

The tests marked ``cuda`` hold the hand-written kernels against their plain
version on the card and skip without one: the wrapper's route and each
kernel by ``launch`` at shapes both take and around the crossover
(``SCAN_MIN_SEQ``), strided model views on the chunked kernel, bitwise
repeatability over calls and graph replays, one profiler kernel a call. In float32 the tolerance is 1e-5
of the largest |y| (and of the largest |h| for the state), over thousands
of steps: y_t sums N products C_t[n] h_t[n], each as large as the state,
which grow to hundreds and cancel, and the kernel adds them in another
order than the plain version, so an element of y far below the largest
can differ by ~1e-7 of the state's size. In bfloat16, 2e-2 as above. They
need no JAX: there, run
``python -m pytest -q -m cuda tests/test_torch_mamba_scan.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops
from repro_torch.kernels.ref import mamba_scan_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_inputs(seed, b, s, d, n):
    """(x, dt, b_mat, c_mat, a, d_vec) as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d))))      # softplus
    b_mat = rng.standard_normal((b, s, n))
    c_mat = rng.standard_normal((b, s, n))
    a = -np.exp(rng.standard_normal((d, n)))                     # stable
    d_vec = rng.standard_normal(d)
    return tuple(v.astype(np.float32) for v in (x, dt, b_mat, c_mat, a,
                                                d_vec))


def as_torch(arrays, dtype, device="cpu"):
    """x, dt, b_mat, c_mat in ``dtype``; a and d_vec float32."""
    tdt = TORCH_DTYPES[dtype]
    return tuple(torch.from_numpy(v).to(device, tdt if i < 4 else
                                        torch.float32)
                 for i, v in enumerate(arrays))


def as_jax(arrays, dtype):
    import jax.numpy as jnp

    return tuple(jnp.asarray(v).astype(getattr(jnp, dtype) if i < 4
                                       else jnp.float32)
                 for i, v in enumerate(arrays))


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,d,n,block_s,block_d", [
    (1, 128, 128, 16, 64, 128),   # two sequence chunks
    (2, 256, 256, 16, 128, 128),  # two channel blocks
    (1, 64, 128, 8, 64, 64),      # narrow state / small blocks
])
def test_matches_the_pallas_kernel_and_the_oracle(b, s, d, n, block_s,
                                                  block_d, dtype):
    from repro.kernels import ref as jref
    from repro.kernels.mamba_scan import mamba_scan as jax_kernel

    arrays = make_inputs(b * 1000 + s + d + n, b, s, d, n)
    y, h = ops.mamba_scan_op(*as_torch(arrays, dtype))
    assert y.dtype == TORCH_DTYPES[dtype] and y.shape == (b, s, d)
    assert h.dtype == torch.float32 and h.shape == (b, d, n)
    jargs = as_jax(arrays, dtype)
    for jy, jh in (jax_kernel(*jargs, block_d=block_d, block_s=block_s,
                              interpret=True),
                   jref.mamba_scan_ref(*jargs)):
        close(y, jy, TOL[dtype])
        close(h, jh, TOL[dtype])


def test_state_carry_over_chunk_boundaries():
    """One sequence of 96 steps: the port's scan equals the Pallas kernel
    run in chunks of 32 (state carried across two boundaries) and in one
    chunk of 96."""
    from repro.kernels.mamba_scan import mamba_scan as jax_kernel

    arrays = make_inputs(8, 1, 96, 64, 16)
    y, h = mamba_scan_ref(*as_torch(arrays, "float32"))
    for block_s in (32, 96):
        jy, jh = jax_kernel(*as_jax(arrays, "float32"), block_d=64,
                            block_s=block_s, interpret=True)
        close(y, jy, 1e-5)
        close(h, jh, 1e-5)


@pytest.mark.parametrize("s", [1, 37, 100])
def test_sequence_that_divides_no_chunk(s):
    """The Pallas kernel pads S to its block with dt = 0; the port pads
    nothing: both give the same y on the real steps and the same state."""
    from repro.kernels.mamba_scan import mamba_scan as jax_kernel

    arrays = make_inputs(s, 2, s, 128, 16)
    y, h = mamba_scan_ref(*as_torch(arrays, "float32"))
    jy, jh = jax_kernel(*as_jax(arrays, "float32"), block_d=128, block_s=32,
                        interpret=True)
    assert jy.shape == (2, s, 128)
    close(y, jy, TOL["float32"])
    close(h, jh, TOL["float32"])


def test_starting_state_h0():
    """With h0 the scan continues a sequence: the two halves with the first
    half's state carried equal the whole, and equal the reference's oracle
    given the same h0."""
    from repro.kernels import ref as jref

    arrays = make_inputs(3, 2, 40, 32, 8)
    x, dt, b_mat, c_mat, a, d_vec = as_torch(arrays, "float32")
    y, h = mamba_scan_ref(x, dt, b_mat, c_mat, a, d_vec)
    y1, h1 = mamba_scan_ref(x[:, :25], dt[:, :25], b_mat[:, :25],
                            c_mat[:, :25], a, d_vec)
    y2, h2 = mamba_scan_ref(x[:, 25:], dt[:, 25:], b_mat[:, 25:],
                            c_mat[:, 25:], a, d_vec, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(h2, h, rtol=1e-6, atol=1e-6)
    jargs = as_jax([v[:, 25:] if i < 4 else v
                    for i, v in enumerate(arrays)], "float32")
    jy, jh = jref.mamba_scan_ref(*jargs, h0=h1.numpy())
    close(y2, jy, 1e-5)
    close(h2, jh, 1e-5)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    args = as_torch(make_inputs(0, 1, 12, 16, 4), "bfloat16")
    before = ms.mamba_scan.launches
    y, h = ops.mamba_scan_op(*args)
    want_y, want_h = mamba_scan_ref(*args)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)
    assert ms.mamba_scan.launches == before


def meta_inputs(b=1, s=8, d=16, n=16, x=torch.float32, dt=torch.float32,
                bc=torch.float32):
    e = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    return [e((b, s, d), x), e((b, s, d), dt), e((b, s, n), bc),
            e((b, s, n), bc), e((d, n), torch.float32),
            e((d,), torch.float32)]


@pytest.mark.parametrize("change,error,match", [
    (dict(x=torch.float16), TypeError, "x in float32 or bfloat16"),
    (dict(dt=torch.bfloat16), TypeError, "x's dtype"),
    (dict(bc=torch.bfloat16), TypeError, "x's dtype"),
    (dict(n=12), ValueError, "state dim N=12"),
    (dict(n=64), ValueError, "state dim N=64"),
    (dict(s=0), ValueError, "S, D >= 1"),
])
def test_check_refuses_what_the_kernel_does_not_take(change, error, match):
    with pytest.raises(error, match=match):
        ms._check(*meta_inputs(**change))


def test_check_refuses_mismatched_shapes_strides_and_devices():
    args = meta_inputs()
    for i, bad in ((1, torch.empty((1, 8, 15), device="meta")),
                   (3, torch.empty((1, 8, 8), device="meta")),
                   (4, torch.empty((16, 8), device="meta")),
                   (5, torch.empty((8,), device="meta"))):
        with pytest.raises(ValueError, match="mamba_scan"):
            ms._check(*args[:i], bad, *args[i + 1:])
    with pytest.raises(TypeError, match="a and d_vec in float32"):
        ms._check(*args[:4], args[4].bfloat16(), args[5])
    strided = torch.empty((1, 16, 8), device="meta").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        ms._check(strided, *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        ms._check(*args[:4], torch.empty((16, 16), device="meta").t(),
                  args[5])
    # everything else in order: the meta device is refused last
    with pytest.raises(ValueError, match="one CUDA device"):
        ms._check(*args)
    with pytest.raises(ValueError, match="one CUDA device"):
        ms.mamba_scan(*args)


def test_model_dtypes_are_taken_by_the_check():
    """x bf16 with dt, B, C float32 (what the model passes), all bf16 (what
    the JAX tests pass) and all float32 pass every check but the device."""
    for kw in (dict(x=torch.bfloat16), dict(x=torch.bfloat16,
                                            dt=torch.bfloat16,
                                            bc=torch.bfloat16), {}):
        with pytest.raises(ValueError, match="one CUDA device"):
            ms._check(*meta_inputs(**kw))


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def kernel_vs_plain(cuda, arrays, x_dtype, dt_dtype, bc_dtype, tol,
                    kernel=None):
    """The wrapper's call (``kernel`` None: the route ``plan`` picks) or
    ``ms.launch`` of ``kernel`` against the plain version."""
    x, dt, b_mat, c_mat, a, d_vec = (torch.from_numpy(v).to(cuda)
                                     for v in arrays)
    x = x.to(TORCH_DTYPES[x_dtype])
    dt = dt.to(TORCH_DTYPES[dt_dtype])
    b_mat = b_mat.to(TORCH_DTYPES[bc_dtype])
    c_mat = c_mat.to(TORCH_DTYPES[bc_dtype])
    before = ms.mamba_scan.launches
    route = kernel or ms.plan(*x.shape, b_mat.shape[-1],
                              ms.rows_aligned(x, dt))["route"]
    routed = ms.mamba_scan.routes[route]
    y, h = (ms.mamba_scan(x, dt, b_mat, c_mat, a, d_vec) if kernel is None
            else ms.launch(x, dt, b_mat, c_mat, a, d_vec, kernel=kernel))
    torch.cuda.synchronize()
    assert ms.mamba_scan.launches == before + 1
    assert ms.mamba_scan.routes[route] == routed + 1
    want_y, want_h = mamba_scan_ref(x, dt, b_mat, c_mat, a, d_vec)
    assert y.dtype == x.dtype and y.shape == want_y.shape
    assert h.dtype == torch.float32 and h.shape == want_h.shape
    for got, want in ((y.float(), want_y.float()), (h, want_h)):
        atol = tol * want.abs().max().item() if x_dtype == "float32" else tol
        torch.testing.assert_close(got, want, rtol=tol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,n", [
    (1, 128, 128, 16),
    (2, 256, 256, 16),
    (1, 64, 128, 8),
    (2, 100, 200, 16),      # S divides no chunk, D no block
    (3, 33, 70, 32),        # N 32
    (1, 17, 50, 4),         # N 4: one lane a channel
    (2, 9, 30, 2),
    (1, 5, 9, 1),
    (1, 1, 64, 16),         # one step
])
def test_kernel_matches_plain_version_float32(cuda, b, s, d, n):
    kernel_vs_plain(cuda, make_inputs(b + s + d + n, b, s, d, n),
                    "float32", "float32", "float32", 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dt_dtype,bc_dtype", [
    ("float32", "float32"),     # what the model passes
    ("bfloat16", "bfloat16"),   # what the JAX kernel tests pass
    ("bfloat16", "float32"),
    ("float32", "bfloat16"),
])
@pytest.mark.parametrize("b,s,d,n", [(2, 150, 300, 16), (1, 64, 256, 8)])
def test_kernel_matches_plain_version_bfloat16(cuda, b, s, d, n, dt_dtype,
                                               bc_dtype):
    kernel_vs_plain(cuda, make_inputs(s + d, b, s, d, n), "bfloat16",
                    dt_dtype, bc_dtype, 2e-2)


@pytest.mark.cuda
def test_kernel_holds_1e_5_over_4096_steps(cuda):
    assert ms.plan(1, 4096, 256, 16)["route"] == "chunked"
    kernel_vs_plain(cuda, make_inputs(4096, 1, 4096, 256, 16), "float32",
                    "float32", "float32", 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ms.ROUTES)
@pytest.mark.parametrize("b,s,d,n,x_dtype,tol", [
    (1, ms.SCAN_MIN_SEQ - 1, 256, 16, "float32", 1e-5),   # the crossover
    (1, ms.SCAN_MIN_SEQ, 256, 16, "float32", 1e-5),
    (2, 300, 200, 8, "float32", 1e-5),       # S divides no chunk, D no block
    (1, ms.CHUNK + 1, 64, 32, "float32", 1e-5),
    (3, 1000, 1000, 4, "float32", 1e-5),
    (1, 2 * ms.CHUNK, 48, 1, "float32", 1e-5),
    (1, 1, 64, 16, "float32", 1e-5),         # one step
    (2, 150, 304, 16, "bfloat16", 2e-2),
    (2, 16, 8192, 16, "bfloat16", 2e-2),     # the router's batches
])
def test_both_kernels_match_plain_version(cuda, kernel, b, s, d, n, x_dtype,
                                          tol):
    kernel_vs_plain(cuda, make_inputs(b + s + d + n, b, s, d, n), x_dtype,
                    "float32", "float32", tol, kernel=kernel)


@pytest.mark.cuda
def test_chunked_kernel_reads_the_models_strided_views(cuda):
    """x as the model makes it (the first half of the in-projection
    [B,S,2D]) and B, C as column views of one projection [B,S,rk+2N], with
    rows that start 24 bytes in: y and h equal the contiguous inputs'
    result, bit for bit, through the chunked kernel."""
    s = ms.SCAN_MIN_SEQ + 5
    x, dt, b_mat, c_mat, a, d_vec = (torch.from_numpy(v).to(cuda) for v in
                                     make_inputs(10, 2, s, 96, 16))
    xz = torch.cat([x, torch.zeros_like(x)], dim=-1)
    proj = torch.cat([torch.zeros((2, s, 6), device=cuda), b_mat, c_mat],
                     dim=-1)
    x_view, b_view, c_view = xz[..., :96], proj[..., 6:22], proj[..., 22:]
    assert not x_view.is_contiguous() and not b_view.is_contiguous()
    assert ms.plan(2, s, 96, 16, ms.rows_aligned(x_view, dt))["route"] \
        == "chunked"
    routed = ms.mamba_scan.routes["chunked"]
    y, h = ms.mamba_scan(x_view, dt, b_view, c_view, a, d_vec)
    want_y, want_h = ms.mamba_scan(x, dt, b_mat, c_mat, a, d_vec)
    assert ms.mamba_scan.routes["chunked"] == routed + 2
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)


@pytest.mark.cuda
def test_chunked_kernel_is_bitwise_repeatable(cuda):
    """Two calls and three replays of a captured call give the same bits:
    the sums run in a fixed order, with no atomics."""
    args = as_torch(make_inputs(11, 1, 1000, 512, 16), "bfloat16", cuda)
    args = (args[0], args[1].float(), args[2].float(), args[3].float(),
            *args[4:])
    first = ms.launch(*args, kernel="chunked")
    second = ms.launch(*args, kernel="chunked")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ms.launch(*args, kernel="chunked")
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ms.launch(*args, kernel="chunked")
    for out in (second,):
        for got, want in zip(out, first):
            assert torch.equal(got, want)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, first):
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,name", [("seq", "mamba_scan_kernel"),
                                         ("chunked",
                                          "mamba_scan_chunked_kernel")])
def test_profiler_sees_one_scan_kernel_a_call(cuda, kernel, name):
    from torch.profiler import ProfilerActivity, profile

    args = as_torch(make_inputs(12, 1, 512, 256, 16), "float32", cuda)
    ms.launch(*args, kernel=kernel)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ms.launch(*args, kernel=kernel)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_time_total > 0}
    assert len(kernels) == 1, kernels
    key, count = next(iter(kernels.items()))
    assert name in key and count == 3


@pytest.mark.cuda
def test_launch_refuses_a_kernel_that_does_not_take_the_shape(cuda):
    x, dt, b_mat, c_mat, a, d_vec = as_torch(
        make_inputs(13, 1, 300, 100, 16), "float32", cuda)
    with pytest.raises(ValueError, match="does not take"):
        ms.launch(x, dt, b_mat, c_mat, a, d_vec, kernel="chunked")  # D 100
    with pytest.raises(ValueError, match="does not take"):
        ms.launch(x, dt, b_mat, c_mat, a, d_vec, kernel="wgmma")
    y, _ = ms.launch(x, dt, b_mat, c_mat, a, d_vec, kernel="seq")
    assert torch.isfinite(y).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_kernel_at_the_lm_router_batches(cuda, b):
    """The router's Falcon-Mamba forwards: 16-token prompts, D 8192, N 16,
    x bf16 with dt, B, C float32."""
    kernel_vs_plain(cuda, make_inputs(b, b, 16, 8192, 16), "bfloat16",
                    "float32", "float32", 2e-2)


@pytest.mark.cuda
def test_kernel_reads_the_models_strided_views(cuda):
    """B and C as the model makes them in float32: column views of one
    projection [B,S,rk+2N]; y and h equal the contiguous inputs' result."""
    x, dt, b_mat, c_mat, a, d_vec = (torch.from_numpy(v).to(cuda) for v in
                                     make_inputs(9, 2, 70, 96, 16))
    proj = torch.cat([torch.zeros((2, 70, 6), device=cuda), b_mat, c_mat],
                     dim=-1)
    b_view, c_view = proj[..., 6:22], proj[..., 22:]
    assert not b_view.is_contiguous()
    y, h = ms.mamba_scan(x, dt, b_view, c_view, a, d_vec)
    want_y, want_h = ms.mamba_scan(x, dt, b_mat, c_mat, a, d_vec)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [32, ms.SCAN_MIN_SEQ])   # both kernels
def test_cuda_path_never_calls_the_plain_version(cuda, monkeypatch, s):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(ms, "mamba_scan_ref", refuse)
    args = as_torch(make_inputs(1, 1, s, 64, 16), "float32", cuda)
    route = ms.plan(1, s, 64, 16)["route"]
    routed = ms.mamba_scan.routes[route]
    y, h = ops.mamba_scan_op(*args)
    torch.cuda.synchronize()
    assert ms.mamba_scan.routes[route] == routed + 1
    assert y.is_cuda and torch.isfinite(y).all() and torch.isfinite(h).all()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    x, dt, b_mat, c_mat, a, d_vec = as_torch(make_inputs(2, 1, 8, 16, 16),
                                             "float32", cuda)
    with pytest.raises(TypeError):
        ms.mamba_scan(x.half(), dt, b_mat, c_mat, a, d_vec)
    with pytest.raises(ValueError, match="state dim"):
        ms.mamba_scan(x, dt, b_mat[..., :12], c_mat[..., :12], a[:, :12],
                      d_vec)
    with pytest.raises(ValueError, match="one CUDA device"):
        ms.mamba_scan(x, dt, b_mat, c_mat, a.cpu(), d_vec)
