"""Residual add and LayerNorm or RMSNorm in one launch: the hand-written
Hopper kernel (``csrc/add_norm.cu``) and its wrapper.

The kernel replaces no TPU kernel: the JAX package leaves the chain to XLA,
which fuses it on the TPU, while the port's eager chain launched a kernel a
step (14 for a LayerNorm, 9 for an RMSNorm, one more for the residual add),
and a served expert's forward is bound by those launches. It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
at first use (``build.load_library``) and loaded with ``ctypes``. A tensor
on the CPU takes the plain version (``ref.add_norm_ref``, the model's own
chain); a CUDA tensor launches the kernel or raises. ``add_norm.launches``
counts the launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import (call_on, current_raw_stream,
                                       load_library)
from repro_torch.kernels.ref import add_norm_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "add_norm.cu"
DTYPES = (torch.float32, torch.bfloat16)
NORM_TYPES = ("layernorm", "rmsnorm")
GROUP = 8                  # elements a thread loads at once
MAX_DIM = GROUP * 4 * 1024     # four groups a thread, 1024 threads a row


def _bind(lib):
    fn = lib.coserve_add_norm
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_longlong] * 2 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.coserve_add_norm_error_string.argtypes = [ctypes.c_int]
    lib.coserve_add_norm_error_string.restype = ctypes.c_char_p


def _rows(name: str, t, d: int):
    """(rows, row stride) of ``t`` [..., d] as rows with a unit element
    stride, a row stride of whole 16-byte vectors and a 16-byte aligned
    start, without a copy."""
    if t.is_contiguous():
        rows, stride = t.numel() // d, d
    else:
        flat = t.reshape(-1, d)
        if flat.data_ptr() != t.data_ptr() or flat.stride(1) != 1:
            raise ValueError(f"add_norm: {name} {tuple(t.shape)} with "
                             f"strides {t.stride()} is not rows of unit "
                             f"element stride")
        rows, stride = flat.shape[0], flat.stride(0)
    if stride % GROUP or t.data_ptr() % 16:
        raise ValueError(f"add_norm: {name} needs a row stride that is a "
                         f"multiple of {GROUP} and a 16-byte aligned start; "
                         f"got strides {t.stride()}")
    return rows, stride


def _check(x, scale, bias, delta, layer: bool):
    d, dev = x.shape[-1], x.get_device()
    if dev < 0 or x.dtype not in DTYPES:
        raise ValueError(f"add_norm: x must be a float32 or bfloat16 CUDA "
                         f"tensor, got {x.dtype} on {x.device}")
    if d % GROUP or not GROUP <= d <= MAX_DIM:
        raise ValueError(f"add_norm: the last dim {d} must be a multiple of "
                         f"{GROUP} up to {MAX_DIM}")
    params = (("scale", scale), ("bias", bias)) if layer else (
        ("scale", scale),)
    for name, p in params:
        if p is None or p.shape != (d,) or p.dtype != scale.dtype \
                or p.dtype not in DTYPES or p.get_device() != dev \
                or p.stride(0) != 1 or p.data_ptr() % 16:
            raise ValueError(f"add_norm: {name} must be a contiguous, "
                             f"16-byte aligned [{d}] float32 or bfloat16 "
                             f"tensor beside x (scale and bias of one dtype)")
    if delta is not None and (delta.shape != x.shape or delta.dtype != x.dtype
                              or delta.get_device() != dev):
        raise ValueError(f"add_norm: delta {tuple(delta.shape)} "
                         f"{delta.dtype} does not match x {tuple(x.shape)} "
                         f"{x.dtype}")


def add_norm(x, scale, bias=None, delta=None, *, norm_type: str,
             eps: float):
    """x (and ``delta``) [..., d] -> (s, out), both in x's dtype: s = x +
    delta (x itself without a delta), out the ``norm_type`` of s over the
    last dim with ``scale`` (and ``bias``, LayerNorm only) [d].

    The host's cost per call is what the model step is bound by, so the
    checks read only cheap attributes and the stream is read raw."""
    if x.is_cpu:
        return add_norm_ref(x, scale, bias, delta, norm_type=norm_type,
                            eps=eps)
    if norm_type not in NORM_TYPES:
        raise ValueError(f"add_norm: norm_type {norm_type!r} is not one of "
                         f"{NORM_TYPES}")
    layer = norm_type == "layernorm"
    _check(x, scale, bias, delta, layer)
    d, dev = x.shape[-1], x.get_device()
    rows, x_rs = _rows("x", x, d)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if rows == 0:
        return (x if delta is None else x + delta), out
    if delta is None:
        s, d_rs = x, 0
    else:
        d_rs = _rows("delta", delta, d)[1]
        s = torch.empty_like(x, memory_format=torch.contiguous_format)
    lib = load_library(SOURCE, _bind)
    args = (x.data_ptr(), None if delta is None else delta.data_ptr(),
            scale.data_ptr(), bias.data_ptr() if layer else None,
            None if delta is None else s.data_ptr(), out.data_ptr(), rows, d,
            x_rs, d_rs, eps, layer, x.dtype == torch.bfloat16,
            scale.dtype == torch.bfloat16, current_raw_stream(dev))
    rc = call_on(dev, lib.coserve_add_norm, *args)
    if rc != 0:
        raise RuntimeError(
            f"add_norm kernel launch failed: CUDA error {rc} "
            f"({lib.coserve_add_norm_error_string(rc).decode()})")
    add_norm.launches += 1
    return s, out


add_norm.launches = 0
