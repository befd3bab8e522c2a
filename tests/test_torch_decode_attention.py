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
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
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
    monkeypatch.setattr(build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    for source in (da.SOURCE, fa.SOURCE):     # both kernels build through it
        if not build.library_path(source).exists():
            with pytest.raises(RuntimeError, match="nvcc not found"):
                build.build_library(source)


def test_library_is_keyed_by_its_source():
    paths = {build.library_path(s) for s in (da.SOURCE, fa.SOURCE)}
    assert len(paths) == 2
    for source in (da.SOURCE, fa.SOURCE):
        path = build.library_path(source)
        assert path.parent == build.BUILD_DIR and path.suffix == ".so"
        assert path.name.startswith(source.stem + "-")
        assert path == build.library_path(source)


# The split planner runs on shapes alone: (B, Hkv, W, D, G, kv bytes, SMs)
# -> (tile, rows a block, splits).
@pytest.mark.parametrize("shape,want", [
    ((1, 8, 4096, 128, 3, 2, 132), (64, 3, 32)),   # phi4-mini bf16: 256 blocks
    ((1, 2, 4096, 128, 12, 2, 132), (64, 4, 32)),  # starcoder2-3b: 3 chunks
    ((1, 2, 64, 64, 2, 4, 132), (64, 2, 1)),       # the engine's ring: 1 tile
    ((2, 2, 528, 128, 12, 4, 132), (32, 4, 9)),    # fp32 rows: 32-slot tiles
    ((2, 1, 100, 256, 8, 4, 132), (16, 4, 4)),     # fp32 D 256: 16-slot tiles
    ((1, 1, 512, 64, 6, 2, 132), (64, 3, 4)),      # G 6: two chunks of 3
    ((64, 8, 4096, 128, 3, 2, 132), (64, 3, 1)),   # enough rows for the card
])
def test_plan_at_the_served_geometries(shape, want):
    assert da.plan(*shape) == want


def test_plan_stays_within_the_kernels_limits():
    for b, (hkv, g), w, (d, kv_bytes) in itertools.product(
            (1, 3, 16), ((1, 128), (2, 12), (8, 3), (32, 1), (4, 7)),
            (1, 63, 64, 65, 1000, 4096, 65537),
            ((32, 4), (128, 2), (128, 4), (256, 4))):
        if g * d > da.MAX_GROUP_ELEMS:
            continue
        shape = (b, hkv, w, d, g, kv_bytes, 132)
        tile, rows, splits = da.plan(*shape)
        n_tiles = -(-w // tile)
        chunks = -(-g // rows)
        assert 16 <= tile <= da.MAX_TILE and tile % 16 == 0, shape
        assert 2 * tile * d * kv_bytes <= da.STAGE_BYTES, shape
        # equal chunks of at most ROWS_PER_BLOCK rows cover the group
        assert rows <= da.ROWS_PER_BLOCK and (chunks - 1) * rows < g, shape
        assert 1 <= splits <= max(1, -(-n_tiles // da.MIN_TILES_PER_SPLIT)), \
            shape
        assert splits * rows <= da.MAX_COMBINE, shape
        # the grid stays near one wave of BLOCKS_PER_SM blocks an SM
        assert b * hkv * chunks * (splits - 1) < da.BLOCKS_PER_SM * 132, \
            shape


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


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [("bfloat16", "bfloat16"),
                                              ("float32", "float32")])
@pytest.mark.parametrize("b,h,hkv,w,d,window", [
    (1, 24, 8, 4096, 128, 0),    # phi4-mini: 64 tiles (128 fp32), 32 splits
    (1, 24, 2, 1000, 128, 0),    # three chunks of 4 rows, 8 (16) splits
    (2, 8, 4, 3000, 64, 0),      # 47 tiles over 24 splits, ragged last tile
    (2, 12, 4, 700, 64, 300),    # a window across tiles, 6 splits
])
@pytest.mark.parametrize("pos_of", ["W/3", "W-1", "3W+17"])
def test_split_combine_in_one_launch(cuda, q_dtype, kv_dtype, b, h, hkv, w,
                                     d, window, pos_of):
    """Splits >= 2 combined by the last split in the same launch; tile
    counts that are not multiples of the splits; pos < W and pos >= 3W."""
    pos = {"W/3": w // 3, "W-1": w - 1, "3W+17": 3 * w + 17}[pos_of]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    kv_bytes = 2 if kv_dtype == "bfloat16" else 4
    tile, rows, splits = da.plan(b, hkv, w, d, h // hkv, kv_bytes, sms)
    assert splits >= 2
    q, k, v = make_inputs(pos + w + d, b, h, hkv, w, d)
    tq, tk, tv = (t.to(cuda) for t in as_torch(q, k, v, q_dtype, kv_dtype))
    before = da.decode_attention.launches
    got = da.decode_attention(tq, tk, tv, pos, window=window)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    want = decode_attention_ref(tq, tk, tv, pos, window=window)
    tol = TOL[q_dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_masked_slots_never_reach_the_sums(cuda):
    """Slots the mask rejects may hold anything (NaN here, as in a ring not
    yet written): the output stays finite and equal to the plain version
    on a cache whose masked slots are zero."""
    q, k, v = make_inputs(11, 1, 24, 8, 4096, 128)
    tq, tk, tv = (t.to(cuda) for t in as_torch(q, k, v, "bfloat16",
                                                "bfloat16"))
    pos, window = 2500, 1000
    slots = torch.arange(4096, device=cuda)
    abs_pos = pos - torch.remainder(pos - slots, 4096)
    masked = (abs_pos < 0) | (pos - abs_pos >= window)
    tk[:, :, masked] = float("nan")
    tv[:, :, masked] = float("nan")
    got = da.decode_attention(tq, tk, tv, pos, window=window)
    clean_k, clean_v = tk.clone(), tv.clone()
    clean_k[:, :, masked] = 0
    clean_v[:, :, masked] = 0
    want = decode_attention_ref(tq, clean_k, clean_v, pos, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype,w", [("bfloat16", "bfloat16", 4096),
                                                ("float32", "float32", 528),
                                                ("float32", "float32", 64)])
def test_repeated_calls_and_graph_replays_are_bitwise_equal(cuda, q_dtype,
                                                            kv_dtype, w):
    """The combine adds the splits in split order whichever block ends
    last, and resets its counter: two calls, and replays of a captured
    graph, give the same bits."""
    q, k, v = make_inputs(w, 1, 24, 8, w, 128)
    tq, tk, tv = (t.to(cuda) for t in as_torch(q, k, v, q_dtype, kv_dtype))
    pos = 3 * w + 17
    first = da.decode_attention(tq, tk, tv, pos)
    second = da.decode_attention(tq, tk, tv, pos)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.decode_attention(tq, tk, tv, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = da.decode_attention(tq, tk, tv, pos)
    replays = []
    for _ in range(3):
        graph.replay()
        replays.append(captured.clone())
    after = da.decode_attention(tq, tk, tv, pos)
    torch.cuda.synchronize()
    for out in (second, *replays, after):
        assert torch.equal(out, first)
    want = decode_attention_ref(tq, tk, tv, pos)
    tol = TOL[q_dtype]
    torch.testing.assert_close(first.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype,w", [("bfloat16", "bfloat16", 4096),
                                                ("float32", "float32", 1000)])
def test_calls_on_two_streams_keep_their_own_tickets(cuda, q_dtype, kv_dtype,
                                                     w):
    """Two streams, each running the kernel with splits on its own inputs,
    many calls issued in turns without waiting: every result equals the
    plain version. With one set of tickets for the device the splits of
    the two streams' calls would draw each other's tickets, and a combine
    would run early or not at all."""
    b, h, hkv, d = 1, 24, 8, 128
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    kv_bytes = 2 if kv_dtype == "bfloat16" else 4
    assert da.plan(b, hkv, w, d, h // hkv, kv_bytes, sms)[2] >= 2
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    inputs = []
    for i in range(2):
        q, k, v = make_inputs(100 + i, b, h, hkv, w, d)
        inputs.append(tuple(t.to(cuda) for t in as_torch(q, k, v, q_dtype,
                                                         kv_dtype)))
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for it in range(40):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(da.decode_attention(*inputs[i], 3 * w + it))
    torch.cuda.synchronize()
    tol = TOL[q_dtype]
    for i in range(2):
        for it, got in enumerate(outs[i]):
            want = decode_attention_ref(*inputs[i], 3 * w + it)
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)


@pytest.mark.cuda
def test_two_graphs_keep_their_own_tickets(cuda):
    """Two graphs captured on the default capture stream, each holding
    calls with splits: replayed second first, in turns, and then both at
    once on two streams, every result equals the plain version. Graphs
    that shared one set of counters would find them unzeroed at a first
    replay, or draw each other's tickets when replayed together."""
    b, h, hkv, d, w = 1, 24, 8, 128, 4096
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert da.plan(b, hkv, w, d, h // hkv, 2, sms)[2] >= 2
    inputs, graphs, outs = [], [], []
    for i in range(2):
        q, k, v = make_inputs(200 + i, b, h, hkv, w, d)
        inputs.append(tuple(t.to(cuda) for t in as_torch(q, k, v, "bfloat16",
                                                         "bfloat16")))
    da.decode_attention(*inputs[0], 3 * w)       # build and load, eagerly
    for i in range(2):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append([da.decode_attention(*inputs[i], 3 * w + j)
                         for j in range(4)])
        graphs.append(graph)
    want = [[decode_attention_ref(*inputs[i], 3 * w + j) for j in range(4)]
            for i in range(2)]

    def check(graphs_run):
        torch.cuda.synchronize()
        for i in graphs_run:
            for got, ref in zip(outs[i], want[i]):
                torch.testing.assert_close(got.float(), ref.float(),
                                           rtol=TOL["bfloat16"],
                                           atol=TOL["bfloat16"])

    for i in (1, 0, 1, 0):
        graphs[i].replay()
        check((i,))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(20):
        for graph, s in zip(graphs, streams):
            with torch.cuda.stream(s):
                graph.replay()
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    check((0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [-1, -5])
@pytest.mark.parametrize("b,h,hkv,w,d,kv_dtype", [
    (1, 4, 2, 64, 64, "float32"),         # one tile, one split
    (1, 24, 8, 4096, 128, "bfloat16"),    # 32 splits
    (2, 24, 2, 100, 128, "float32"),      # three row chunks, ragged tile
])
def test_no_valid_slot_averages_v_on_the_card(cuda, pos, b, h, hkv, w, d,
                                              kv_dtype):
    """pos < 0: every slot is read and scored -1e30, so each row is the
    average of v over the W slots, as the plain version gives."""
    q, k, v = make_inputs(w - pos, b, h, hkv, w, d)
    tq, tk, tv = (t.to(cuda) for t in as_torch(q, k, v, kv_dtype, kv_dtype))
    got = da.decode_attention(tq, tk, tv, pos)
    want = decode_attention_ref(tq, tk, tv, pos)
    mean = tv.float().mean(dim=2).repeat_interleave(h // hkv, dim=1)
    tol = TOL[kv_dtype]
    torch.testing.assert_close(want.float(), mean, rtol=tol, atol=tol)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
