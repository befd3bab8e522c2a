"""Mamba-1 selective scan: the hand-written Hopper kernel
(``csrc/mamba_scan.cu``) and its wrapper.

The kernel replaces the Pallas TPU kernel
``repro.kernels.mamba_scan.mamba_scan``. It is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface at first use
(``build.load_library``) and loaded with ``ctypes``. A tensor on the CPU
takes the plain version (``ref.mamba_scan_ref``); a CUDA tensor launches the
kernel or raises. ``mamba_scan.launches`` counts the launches.

The source holds two kernels, and ``plan`` picks one by shape: sequences of
``SCAN_MIN_SEQ`` steps and more, with 16-byte aligned x and dt rows, go to
the chunked kernel (time split across the lanes of a warp); the rest, the
router's 16-token forwards among them, to the sequential kernel. That is
dispatch between two hand-written kernels: either one launches or the call
raises. ``mamba_scan.routes`` counts the launches by kernel.

The TPU kernel's ``block_d`` and ``block_s`` choose its TPU tiling and the
padding of S; the Hopper kernels pick their own tiles and pad nothing, so
the wrapper has neither.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import (call_on, current_raw_stream,
                                       load_library)
from repro_torch.kernels.ref import mamba_scan_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
X_DTYPES = (torch.float32, torch.bfloat16)
STATE_DIMS = (1, 2, 4, 8, 16, 32)
ROUTES = ("seq", "chunked")
# The chunked kernel's geometry, as csrc/mamba_scan.cu fixes it: chunks of
# CHUNK steps, STEPS_PER_LANE consecutive steps a lane, WARPS warps a block.
CHUNK = 128
STEPS_PER_LANE = 16
WARPS = 8
# From one chunk up the chunked kernel takes a call: at Falcon-Mamba's
# width (B 1, D 8192, N 16, x bf16) it is level with the sequential kernel
# at 128 steps and faster from there; chip_smoke.py phase 10, NVIDIA H100
# 80GB HBM3 at 700 W, the two in turns, seq against chunked: S 16 (the
# router's batch of one) 0.0045 against 0.0135 ms, S 128 0.0159 against
# 0.0155, S 512 0.0542 against 0.0503, S 1024 0.1052 against 0.0934,
# S 4096 0.4074 against 0.3495.
SCAN_MIN_SEQ = CHUNK


def plan(batch: int, seq: int, dim: int, n: int,
         aligned: bool = True) -> dict:
    """The kernel a call goes to and its geometry. "chunked" from
    ``SCAN_MIN_SEQ`` steps up when D is a multiple of 8 and x's and dt's
    rows start on 16-byte boundaries (``aligned``: the kernel copies them
    by TMA): ``lanes`` lanes of a warp share a channel's chunk of ``chunk``
    steps, ``steps`` each, and a block of ``threads`` holds ``channels``
    channels. Else "seq": each thread walks ``states`` states of one
    channel in order, ``lanes`` threads a channel, blocks of 128 threads
    over ``channels`` channels."""
    if seq >= SCAN_MIN_SEQ and dim % 8 == 0 and aligned:
        lanes = CHUNK // STEPS_PER_LANE
        channels = WARPS * 32 // lanes
        return {"route": "chunked", "chunk": CHUNK, "steps": STEPS_PER_LANE,
                "lanes": lanes, "channels": channels, "threads": WARPS * 32,
                "blocks": batch * -(-dim // channels)}
    states = min(n, 4)
    channels = 128 // (n // states)
    return {"route": "seq", "chunk": min(32, 1024 // channels),
            "states": states, "lanes": n // states, "channels": channels,
            "threads": 128, "blocks": batch * -(-dim // channels)}


def _bind(lib):
    for fn in (lib.coserve_mamba_scan, lib.coserve_mamba_scan_chunked):
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 8 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.coserve_mamba_scan_chunked_occupancy.argtypes = [ctypes.c_int] * 4
    lib.coserve_mamba_scan_chunked_occupancy.restype = ctypes.c_int
    lib.coserve_mamba_error_string.argtypes = [ctypes.c_int]
    lib.coserve_mamba_error_string.restype = ctypes.c_char_p


def _check(x, dt, b_mat, c_mat, a, d_vec):
    """Raise on any dtype, shape, stride or device the kernel does not
    take (the device last, so the others can be checked on meta tensors)."""
    tensors = {"x": x, "dt": dt, "b_mat": b_mat, "c_mat": c_mat, "a": a,
               "d_vec": d_vec}
    if x.dtype not in X_DTYPES:
        raise TypeError(f"mamba_scan takes x in float32 or bfloat16, got "
                        f"{x.dtype}")
    pair = (torch.float32, x.dtype)
    if dt.dtype not in pair or b_mat.dtype not in pair \
            or c_mat.dtype != b_mat.dtype:
        raise TypeError("mamba_scan takes dt, and b_mat with c_mat, each in "
                        f"float32 or in x's dtype {x.dtype}; got dt "
                        f"{dt.dtype}, b_mat {b_mat.dtype}, c_mat "
                        f"{c_mat.dtype}")
    if a.dtype != torch.float32 or d_vec.dtype != torch.float32:
        raise TypeError(f"mamba_scan takes a and d_vec in float32, got "
                        f"{a.dtype}, {d_vec.dtype}")
    if x.dim() != 3 or dt.shape != x.shape or b_mat.dim() != 3 \
            or c_mat.shape != b_mat.shape:
        raise ValueError("mamba_scan: x, dt [B,S,D] and b_mat, c_mat "
                         f"[B,S,N]; got x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, b_mat {tuple(b_mat.shape)}, "
                         f"c_mat {tuple(c_mat.shape)}")
    bsz, s, d = x.shape
    n = b_mat.shape[-1]
    if b_mat.shape[:2] != (bsz, s) or tuple(a.shape) != (d, n) \
            or tuple(d_vec.shape) != (d,):
        raise ValueError(f"mamba_scan: b_mat {tuple(b_mat.shape)}, a "
                         f"{tuple(a.shape)} and d_vec {tuple(d_vec.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if min(bsz, s, d) < 1 or bsz > 65535:
        raise ValueError(f"mamba_scan: x {tuple(x.shape)} needs B, S, D >= 1 "
                         "and B <= 65535")
    if n not in STATE_DIMS:
        raise ValueError(f"mamba_scan: state dim N={n} must be one of "
                         f"{STATE_DIMS}")
    for name in ("x", "dt", "b_mat", "c_mat"):
        if tensors[name].stride(2) != 1:
            raise ValueError(f"mamba_scan: {name} needs a contiguous last "
                             f"dimension, got strides "
                             f"{tensors[name].stride()}")
    if not (a.is_contiguous() and d_vec.is_contiguous()):
        raise ValueError("mamba_scan: a and d_vec must be contiguous")
    if not x.is_cuda or any(t.device != x.device for t in tensors.values()):
        raise ValueError("mamba_scan: every input must lie on one CUDA "
                         "device, got " + ", ".join(
                             f"{k} on {t.device}" for k, t in tensors.items()))


def occupancy(n: int, x_dtype, dt_dtype, bc_dtype) -> int:
    """Blocks of the chunked kernel an SM holds for state width ``n`` and
    these dtypes, by CUDA's occupancy calculator (needs the card)."""
    lib = load_library(SOURCE, _bind)
    blocks = lib.coserve_mamba_scan_chunked_occupancy(
        n, *(int(t == torch.bfloat16) for t in (x_dtype, dt_dtype,
                                                   bc_dtype)))
    if blocks < 0:
        raise RuntimeError(f"mamba_scan: the occupancy query for N={n} "
                           "was refused")
    return blocks


def rows_aligned(x, dt) -> bool:
    """Whether every row of x and dt starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0
               and all(st * t.element_size() % 16 == 0
                       for st in t.stride()[:2])
               for t in (x, dt))


def mamba_scan(x, dt, b_mat, c_mat, a, d_vec):
    """x, dt: [B,S,D]; b_mat, c_mat: [B,S,N]; a: [D,N]; d_vec: [D].
    Returns (y [B,S,D] in x's dtype, h_final [B,D,N] float32)."""
    if x.device.type == "cpu":
        return mamba_scan_ref(x, dt, b_mat, c_mat, a, d_vec)
    bsz, s, d = x.shape
    route = plan(bsz, s, d, b_mat.shape[-1], rows_aligned(x, dt))["route"]
    return launch(x, dt, b_mat, c_mat, a, d_vec, kernel=route)


def launch(x, dt, b_mat, c_mat, a, d_vec, *, kernel: str):
    """Launch ``kernel`` ("seq" or "chunked") on CUDA tensors, whatever
    ``plan`` would pick; the card-side checks use it to hold both kernels
    against the plain version and against each other."""
    _check(x, dt, b_mat, c_mat, a, d_vec)
    if kernel not in ROUTES or (kernel == "chunked" and (
            x.shape[2] % 8 or not rows_aligned(x, dt))):
        raise ValueError(f"mamba_scan: kernel {kernel!r} does not take x "
                         f"{tuple(x.shape)} with strides {x.stride()}, dt "
                         f"strides {dt.stride()}")
    lib = load_library(SOURCE, _bind)
    bsz, s, d = x.shape
    n = b_mat.shape[-1]
    y = torch.empty((bsz, s, d), dtype=x.dtype, device=x.device)
    h = torch.empty((bsz, d, n), dtype=torch.float32, device=x.device)
    dev = x.get_device()
    fn = (lib.coserve_mamba_scan_chunked if kernel == "chunked"
          else lib.coserve_mamba_scan)
    rc = call_on(
        dev, fn, x.data_ptr(), dt.data_ptr(), b_mat.data_ptr(),
        c_mat.data_ptr(), a.data_ptr(), d_vec.data_ptr(), y.data_ptr(),
        h.data_ptr(), bsz, s, d, n, *x.stride()[:2], *dt.stride()[:2],
        *b_mat.stride()[:2], *c_mat.stride()[:2],
        int(x.dtype == torch.bfloat16), int(dt.dtype == torch.bfloat16),
        int(b_mat.dtype == torch.bfloat16), current_raw_stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"mamba_scan kernel launch failed: CUDA error {rc} "
            f"({lib.coserve_mamba_error_string(rc).decode()})")
    mamba_scan.launches += 1
    mamba_scan.routes[kernel] += 1
    return y, h


mamba_scan.launches = 0
mamba_scan.routes = dict.fromkeys(ROUTES, 0)
