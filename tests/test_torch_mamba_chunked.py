"""The chunked Hopper scan's order of operations, and its route, on the CPU.

``csrc/mamba_scan.cu``'s chunked kernel splits each chunk of a channel's
steps over the lanes of a warp: a lane folds its steps into one (decay,
input) pair, a shuffle scan over the channel's lanes gives each lane its
end state, the first lane joining the state carried from the last chunk,
and a second pass from the left neighbour's end state adds C h into y.
That reorders the products of decays against the sequential recurrence.
``chunked_model`` is that order in float64 numpy; it is held against the
port's plain float32 recurrence and against the Pallas kernel (interpret
mode, as ``tests/test_kernels.py`` runs it) at float32's 2e-5, over
sequences that end before, at and after one chunk, for every state width
the kernel takes. ``plan``, which picks between the chunked and the
sequential kernel, is held against the shapes ``chip_smoke.py`` drives
and the crossover. The kernels themselves run only on the card
(``tests/test_torch_mamba_scan.py``, marked ``cuda``).
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels.ref import mamba_scan_ref
from test_torch_mamba_scan import TOL, as_jax, as_torch, make_inputs


def chunked_model(x, dt, b_mat, c_mat, a, d_vec, chunk=ms.CHUNK,
                  steps=ms.STEPS_PER_LANE):
    """The chunked kernel's order of operations in float64 numpy. Each
    chunk of ``chunk`` steps (zeros past S: identity steps) is split over
    ``chunk // steps`` lanes of ``steps`` steps. A lane folds its steps
    into one pair (a = exp of its summed dt times A, v = its state from
    zero); the first lane joins the carried state; an inclusive
    Hillis-Steele scan over the lanes (offsets 1, 2, 4, ...) with
    ``(a1, v1) then (a2, v2) = (a1 a2, a2 v1 + v2)`` gives each lane its end
    state; a second pass from the left neighbour's end state adds C h into
    y, which starts at D x; the last lane's end state is carried on."""
    x, dt, b_mat, c_mat, a, d_vec = (np.asarray(v, np.float64) for v in
                                     (x, dt, b_mat, c_mat, a, d_vec))
    bsz, s, d = x.shape
    n = b_mat.shape[-1]
    lanes = chunk // steps
    h = np.zeros((bsz, d, n))
    y = np.zeros((bsz, s, d))
    for t0 in range(0, s, chunk):
        rows = min(chunk, s - t0)
        pad = lambda v: np.pad(v[:, t0:t0 + rows],
                               ((0, 0), (0, chunk - rows), (0, 0)))
        xs, dts, bs, cs = pad(x), pad(dt), pad(b_mat), pad(c_mat)
        dec = np.exp(dts[..., None] * a).reshape(bsz, lanes, steps, d, n)
        u = ((dts * xs)[..., None] * bs[:, :, None, :]).reshape(
            bsz, lanes, steps, d, n)
        v = u[:, :, 0]
        for k in range(1, steps):
            v = dec[:, :, k] * v + u[:, :, k]
        av = np.exp(dts.reshape(bsz, lanes, steps, d).sum(2)[..., None] * a)
        v[:, 0] = av[:, 0] * h + v[:, 0]
        off = 1
        while off < lanes:
            v_new, a_new = v.copy(), av.copy()
            v_new[:, off:] = av[:, off:] * v[:, :-off] + v[:, off:]
            a_new[:, off:] = av[:, off:] * av[:, :-off]
            v, av, off = v_new, a_new, 2 * off
        hh = np.concatenate([h[:, None], v[:, :-1]], axis=1)
        acc = (d_vec * xs).reshape(bsz, lanes, steps, d)
        cl = cs.reshape(bsz, lanes, steps, n)
        for k in range(steps):
            hh = dec[:, :, k] * hh + u[:, :, k]
            acc[:, :, k] += np.einsum("bldn,bln->bld", hh, cl[:, :, k])
        y[:, t0:t0 + rows] = acc.reshape(bsz, chunk, d)[:, :rows]
        h = v[:, -1]
    return y, h


@pytest.mark.parametrize("n", ms.STATE_DIMS)
@pytest.mark.parametrize("s", [1, ms.CHUNK - 1, ms.CHUNK, ms.CHUNK + 1])
def test_chunked_order_matches_the_oracle_and_the_pallas_kernel(s, n):
    """The chunked kernel's order of operations, in float64, against the
    sequential float32 recurrence and the Pallas kernel (interpret mode)
    over sequences that end before, at and after a chunk's end."""
    from repro.kernels.mamba_scan import mamba_scan as jax_kernel

    arrays = make_inputs(s * 100 + n, 1, s, 16, n)
    y, h = chunked_model(*arrays)
    want_y, want_h = mamba_scan_ref(*as_torch(arrays, "float32"))
    jy, jh = jax_kernel(*as_jax(arrays, "float32"), block_d=16, block_s=64,
                        interpret=True)
    for got, want in ((y, want_y.numpy()), (h, want_h.numpy()),
                      (y, np.asarray(jy)), (h, np.asarray(jh))):
        np.testing.assert_allclose(got, want, rtol=TOL["float32"],
                                   atol=TOL["float32"])


def test_chunked_order_carries_an_underflowed_decay():
    """A lane whose product of decays underflows to zero (dt 1e3 over its
    steps) hands on only its own inputs, as the sequential order does."""
    arrays = list(make_inputs(5, 1, 3 * ms.CHUNK, 32, 16))
    arrays[1][:, 200:216] = 1e3
    y, h = chunked_model(*arrays)
    want_y, want_h = mamba_scan_ref(*as_torch(arrays, "float32"))
    np.testing.assert_allclose(y, want_y.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(h, want_h.numpy(), rtol=2e-5, atol=2e-5)


def test_plan_geometry_follows_the_cuda_source():
    """The geometry ``plan`` reports is the one csrc/mamba_scan.cu fixes."""
    src = ms.SOURCE.read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);",
                                       src).group(1))
    assert const("kChunk") == ms.CHUNK
    assert const("kStepsPerLane") == ms.STEPS_PER_LANE
    assert const("kWarps") == ms.WARPS


@pytest.mark.parametrize("shape,route,blocks", [
    ((1, 4096, 8192, 16), "chunked", 256),   # phases 10, 11b: the prefill
    ((1, 4096, 2048, 16), "chunked", 64),    # phase 10: fp32, 4096 steps
    ((2, 1000, 1000, 16), "chunked", 64),    # phase 10: ragged fp32
    ((2, 333, 520, 8), "chunked", 34),       # phase 10: all bf16, state 8
    ((2, 512, 8192, 16), "chunked", 512),    # phase 11a: parity forward
    ((1, 16, 8192, 16), "seq", 256),         # phases 10, 12: the router
    ((8, 16, 8192, 16), "seq", 2048),
    ((1, 4096, 1001, 16), "seq", 32),        # D not a multiple of 8
])
def test_plan_routes_the_shapes_chip_smoke_drives(shape, route, blocks):
    got = ms.plan(*shape)
    assert got["route"] == route and got["blocks"] == blocks
    if route == "chunked":
        assert got == {"route": "chunked", "chunk": 128, "steps": 16,
                       "lanes": 8, "channels": 32, "threads": 256,
                       "blocks": blocks}
    else:        # a thread holds 4 states, 128 threads a block
        assert got["threads"] == 128 and got["states"] == 4
        assert got["channels"] == 128 * 4 // shape[3]


@pytest.mark.parametrize("s,route", [(ms.SCAN_MIN_SEQ - 1, "seq"),
                                     (ms.SCAN_MIN_SEQ, "chunked"),
                                     (ms.SCAN_MIN_SEQ + 1, "chunked")])
def test_plan_crossover(s, route):
    assert ms.plan(1, s, 8192, 16)["route"] == route
    assert ms.plan(1, s, 8192, 16, aligned=False)["route"] == "seq"


def test_rows_aligned_reads_strides_and_starts():
    x = torch.zeros((2, 64, 80), dtype=torch.bfloat16)
    dt = torch.zeros((2, 64, 80))
    assert ms.rows_aligned(x, dt)
    assert ms.rows_aligned(torch.zeros((2, 64, 160),
                                       dtype=torch.bfloat16)[..., 80:], dt)
    assert not ms.rows_aligned(x[..., 1:], dt[..., 1:])
    assert not ms.rows_aligned(torch.zeros((2, 64, 84),
                                           dtype=torch.bfloat16)[..., :80],
                               dt)
