"""Forward (prefill) GQA attention: the hand-written Hopper kernel
(``csrc/flash_attention.cu``) and its wrapper.

The kernel replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface at
first use (``build.load_library``) and loaded with ``ctypes``. A tensor on
the CPU takes the plain version (``ref.flash_attention_ref``); a CUDA tensor
launches a kernel or raises. ``flash_attention.launches`` counts the
launches, ``flash_attention.routes`` them by kernel.

The source holds three kernels, and ``route`` picks one by shape: float32
goes to the CUDA-core kernel; bf16 goes to the wgmma + TMA kernel where it
is the faster, else to the mma.sync kernel. That is dispatch between two
hand-written kernels: either one launches or the call raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import (call_on, current_raw_stream,
                                       load_library)
from repro_torch.kernels.ref import flash_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 96, 128)
ROUTES = {"f32": 0, "mma": 1, "wgmma": 2}
WGMMA_HEAD_DIMS = (64, 128)   # whole 64-column swizzled boxes
# From this many query rows up the wgmma kernel takes bf16: up to 64 rows
# both kernels run one q tile a head and the mma.sync kernel's 64-row tile
# wastes less; past 64 it needs two tiles, and the wgmma kernel's one is
# faster. chip_smoke.py phase 7, NVIDIA H100 80GB HBM3 at 700 W,
# starcoder2-3b heads, B 1, mma.sync against wgmma in turns: S 16 0.0058
# against 0.0064 ms, S 64 0.0072 against 0.0077, S 65 0.0089 against
# 0.0075, S 127 0.0103 against 0.0088, S 512 0.0324 against 0.0157.
WGMMA_MIN_SEQ = 65


def route(s: int, d: int, dtype) -> str:
    """The kernel a [B,H,s,d] query of ``dtype`` goes to: "f32" for
    float32, else "wgmma" for head dims 64 and 128 from ``WGMMA_MIN_SEQ``
    query rows up, else "mma"."""
    if dtype == torch.float32:
        return "f32"
    if d in WGMMA_HEAD_DIMS and s >= WGMMA_MIN_SEQ:
        return "wgmma"
    return "mma"


def _bind(lib):
    fn = lib.coserve_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.coserve_flash_error_string.argtypes = [ctypes.c_int]
    lib.coserve_flash_error_string.restype = ctypes.c_char_p


def _check(q, k, v, window: int):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k and v must lie on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes q, k, v all float32 or all "
                        f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q [B,H,S,D], k and v [B,Hkv,T,D]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    kb, hkv, t, kd = k.shape
    if kb != b or kd != d or hkv == 0 or h % hkv or s == 0 or t < s:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k, v {tuple(k.shape)} (needs T >= S > 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} must be one of "
                         f"{HEAD_DIMS}")
    vec = 16 // q.element_size()      # the kernel reads 16-byte vectors
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or any(st % vec for st in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} needs a contiguous last dimension, "
                f"strides that are multiples of {vec} elements and a 16-byte "
                f"aligned start; got strides {x.stride()}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B,H,S,D]; k, v: [B,Hkv,T,D], T >= S -> [B,H,S,D] in q's dtype.

    On the card the result is a [B,H,S,D] view of a [B,S,H,D] buffer, so a
    caller that transposes it back to [B,S,H,D] gets a contiguous tensor
    without a copy."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    return launch(q, k, v, causal=causal, window=window,
                  kernel=route(q.shape[2], q.shape[3], q.dtype))


def launch(q, k, v, *, causal: bool, window: int, kernel: str):
    """Launch ``kernel`` ("f32", "mma" or "wgmma") on CUDA tensors, whatever
    ``route`` would pick; the card-side checks use it to hold both bf16
    kernels against the plain version and against each other."""
    _check(q, k, v, window)
    if kernel not in ROUTES or (kernel == "f32") != (q.dtype == torch.float32) \
            or (kernel == "wgmma" and q.shape[3] not in WGMMA_HEAD_DIMS):
        raise ValueError(f"flash_attention: kernel {kernel!r} does not take "
                         f"{q.dtype} with head_dim {q.shape[3]}")
    lib = load_library(SOURCE, _bind)
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    dev = q.get_device()
    rc = call_on(
        dev, lib.coserve_flash_attention, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), b, h, hkv, s, t, d, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(bool(causal)), int(window), ROUTES[kernel],
        current_raw_stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {rc} "
            f"({lib.coserve_flash_error_string(rc).decode()})")
    flash_attention.launches += 1
    flash_attention.routes[kernel] += 1
    return out


flash_attention.launches = 0
flash_attention.routes = dict.fromkeys(ROUTES, 0)
