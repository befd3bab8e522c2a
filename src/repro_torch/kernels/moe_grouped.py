"""The expert products of a dropless MoE layer over the experts this card
holds, grouped by expert: the hand-written Hopper kernel
(``csrc/moe_grouped.cu``) and its wrapper.

The kernel replaces no TPU kernel: the JAX package's MoE layer is plain
``jnp`` with a capacity (a fixed [groups, experts, capacity, d] buffer),
which XLA compiles. A dropless layer has as many rows an expert as its
tokens chose it, known only on the device; a loop of ``torch.matmul`` over
the experts would read each count on the host, a synchronisation in every
MoE layer of every forward. The kernel takes the counts as a device tensor
and sizes its grid for the worst case. Two launches a call: the first
computes h = silu(x W_gate) * (x W_up) for the sorted rows of every held
expert, reading each row's token through ``order``; the second computes h
W_down, scales each row by its routing weight and writes it to its
(token, choice) place, so that the caller's sum over the choices combines
them without atomics. It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use
(``build.load_library``) and loaded with ``ctypes``. A tensor on the CPU
takes the plain version (``ref.moe_grouped_ref``); a CUDA tensor launches
the kernel or raises. ``moe_grouped.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import (call_on, current_raw_stream,
                                       load_library)
from repro_torch.kernels.ref import moe_grouped_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_grouped.cu"
WIDTH = 128            # d and ff must be multiples of it (a column tile)
MAX_EXPERTS = 64


def _bind(lib):
    fn = lib.coserve_moe_grouped
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.coserve_moe_grouped_error_string.argtypes = [ctypes.c_int]
    lib.coserve_moe_grouped_error_string.restype = ctypes.c_char_p


def _check(x, order, offsets, weights, top_k, w_in, w_down):
    dev = x.get_device()
    tensors = (x, order, offsets, weights, w_in, w_down)
    if dev < 0 or any(t.get_device() != dev for t in tensors):
        raise ValueError("moe_grouped: every tensor must lie on one CUDA "
                         "device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("moe_grouped: every tensor must be contiguous")
    if x.dtype != torch.bfloat16 or w_in.dtype != x.dtype \
            or w_down.dtype != x.dtype:
        raise TypeError(f"moe_grouped takes bfloat16 x and weights, got "
                        f"{x.dtype}, {w_in.dtype}, {w_down.dtype}")
    if order.dtype != torch.int64 or offsets.dtype != torch.int64 \
            or weights.dtype != torch.float32:
        raise TypeError("moe_grouped: order and offsets int64, weights "
                        "float32")
    t, d = x.shape
    e, ff = w_in.shape[0], w_in.shape[-1]
    if w_in.shape != (e, d, 2, ff) or w_down.shape != (e, ff, d) \
            or offsets.shape != (e + 1,) or not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"moe_grouped: w_in [E,d,2,ff], w_down [E,ff,d], "
                         f"offsets [E+1] with E <= {MAX_EXPERTS}; got "
                         f"{tuple(w_in.shape)}, {tuple(w_down.shape)}, "
                         f"{tuple(offsets.shape)} for x {tuple(x.shape)}")
    if order.shape != (t * top_k,) or weights.shape != order.shape:
        raise ValueError(f"moe_grouped: order and weights [T*k] = "
                         f"[{t * top_k}]; got {tuple(order.shape)}, "
                         f"{tuple(weights.shape)}")
    if d % WIDTH or ff % WIDTH:
        raise ValueError(f"moe_grouped: d {d} and ff {ff} must be "
                         f"multiples of {WIDTH}")


def moe_grouped(x, order, offsets, weights, top_k: int, w_in, w_down):
    """out [T*k, d]: each held (token, choice) pair's weighted expert
    output at its flat index, zero for the others (``ref.moe_grouped_ref``
    states the arguments). Two launches on the card, no synchronisation:
    the counts stay on the device."""
    if x.is_cpu:
        return moe_grouped_ref(x, order, offsets, weights, top_k, w_in,
                               w_down)
    _check(x, order, offsets, weights, top_k, w_in, w_down)
    t, d = x.shape
    e, ff = w_in.shape[0], w_in.shape[-1]
    rows = order.shape[0]
    out = torch.zeros((rows, d), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    h = torch.empty((rows, ff), dtype=x.dtype, device=x.device)
    dev = x.get_device()
    lib = load_library(SOURCE, _bind)
    rc = call_on(dev, lib.coserve_moe_grouped, x.data_ptr(),
                 order.data_ptr(), offsets.data_ptr(), weights.data_ptr(),
                 w_in.data_ptr(), w_down.data_ptr(), h.data_ptr(),
                 out.data_ptr(), rows, t, d, ff, e, top_k,
                 current_raw_stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"moe_grouped kernel launch failed: CUDA error {rc} "
            f"({lib.coserve_moe_grouped_error_string(rc).decode()})")
    moe_grouped.launches += 2
    return out


moe_grouped.launches = 0
