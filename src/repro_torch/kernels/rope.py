"""Rotate-half RoPE of the queries and the keys in one launch, in place: the
hand-written Hopper kernel (``csrc/rope.cu``) and its wrapper.

The kernel replaces no TPU kernel: the JAX package leaves RoPE to XLA,
which fuses it on the TPU, while the port's eager chain launched 12 kernels
for q and 12 for k, and a served expert's forward is bound by those
launches. It is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (``build.load_library``) and loaded
with ``ctypes``. A tensor on the CPU takes the plain version
(``ref.rope_ref``, the model's own chain, which returns new tensors); a
CUDA tensor launches the kernel or raises. ``rope.launches`` counts the
launches. M-RoPE (position triples) is not the kernel's: the model keeps it
on the plain chain.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import (call_on, current_raw_stream,
                                       load_library)
from repro_torch.kernels.ref import rope_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rope.cu"
DTYPES = (torch.float32, torch.bfloat16)
PAIRS = 8                  # pairs a thread rotates at once (16 bytes of bf16)
MAX_HEAD_DIM = 1024


def _bind(lib):
    fn = lib.coserve_rope
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 8 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.coserve_rope_error_string.argtypes = [ctypes.c_int]
    lib.coserve_rope_error_string.restype = ctypes.c_char_p


def _check(q, k, positions, freqs):
    dev = q.get_device()
    if dev < 0 or any(t.get_device() != dev for t in (k, positions, freqs)):
        raise ValueError("rope: q, k, positions and freqs must lie on one "
                         f"CUDA device, got {q.device}, {k.device}, "
                         f"{positions.device}, {freqs.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype:
        raise TypeError("rope takes q and k both float32 or both bfloat16, "
                        f"got {q.dtype}/{k.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"rope: q [B,S,Hq,hd] and k [B,S,Hkv,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    b, s, _, hd = q.shape
    if hd % (2 * PAIRS) or hd > MAX_HEAD_DIM:
        raise ValueError(f"rope: head_dim {hd} must be a multiple of "
                         f"{2 * PAIRS} up to {MAX_HEAD_DIM}")
    if q.stride(3) != 1 or k.stride(3) != 1:
        raise ValueError(f"rope: q and k need a contiguous last dimension; "
                         f"got strides {q.stride()}, {k.stride()}")
    if positions.shape != (b, s) or positions.is_floating_point():
        raise ValueError(f"rope: positions must be integers [{b},{s}], got "
                         f"{positions.dtype} {tuple(positions.shape)}")
    if freqs.dtype != torch.float32 or freqs.shape != (hd // 2,) \
            or freqs.stride(0) != 1:
        raise ValueError(f"rope: freqs must be a contiguous float32 "
                         f"[{hd // 2}], got {freqs.dtype} "
                         f"{tuple(freqs.shape)}")


def rope(q, k, positions, freqs):
    """(q, k) rotated: q [B,S,Hq,hd] and k [B,S,Hkv,hd] at the integer
    positions [B,S] (any strides) by the float32 frequencies freqs [hd/2].
    On the card q and k are rotated in place and returned.

    The host's cost per call is what the model step is bound by, so the
    checks read only cheap attributes, the stream is read raw, and the
    kernel's C side refuses strides that are not whole 16-byte vectors and
    unaligned starts (an error the wrapper raises)."""
    if q.is_cpu:
        return rope_ref(q, k, positions, freqs)
    _check(q, k, positions, freqs)
    if q.numel() == 0:
        return q, k
    if positions.dtype != torch.int64:
        positions = positions.long()
    lib = load_library(SOURCE, _bind)
    b, s, hq, hd = q.shape
    dev = q.get_device()
    rc = call_on(dev, lib.coserve_rope, q.data_ptr(), k.data_ptr(),
                 positions.data_ptr(), freqs.data_ptr(), b, s, hq,
                 k.shape[2], hd, *q.stride()[:3], *k.stride()[:3],
                 *positions.stride(), q.dtype == torch.bfloat16,
                 current_raw_stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"rope kernel launch failed: CUDA error {rc} "
            f"({lib.coserve_rope_error_string(rc).decode()}): the kernel "
            f"takes strides of whole 16-byte vectors and 16-byte aligned "
            f"q and k; got strides {q.stride()}, {k.stride()}")
    rope.launches += 1
    return q, k


rope.launches = 0
