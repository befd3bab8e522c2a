"""Time the attention kernels of this checkout against an earlier build of
their sources, in turns, on one CUDA card.

    python -m repro_torch.kernels.compare DIR

``DIR`` holds the earlier ``decode_attention.cu`` and ``flash_attention.cu``
(for example ``git show <commit>:<path>`` of each into a git-ignored
directory). Both are built with this checkout's flags and called through
their own C interfaces: the earlier decode kernel planned its splits in C
(``coserve_decode_attention_splits``) and combined them in a second kernel;
the earlier flash kernel took a bf16 flag where this one takes a route. At
each shape the two builds run earlier, current, current, earlier, each time
by CUDA-graph replay of ``ITERS`` calls over inputs rotated past the L2
cache, and each line gives both means, their ratio and the card.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.build import load_library

ITERS = 20
L2_BYTES = 50 * 2 ** 20
F32, BF16 = torch.float32, torch.bfloat16
# (label, B, H, Hkv, D, W, window, q dtype, kv dtype, pos)
DECODE_SHAPES = [
    ("engine default", 1, 4, 2, 64, 64, 0, F32, F32, 209),
    ("phi4-mini bf16", 1, 24, 8, 128, 4096, 0, BF16, BF16, 12305),
    ("starcoder2-3b decode bf16", 1, 24, 2, 128, 4128, 0, BF16, BF16, 12401),
    ("starcoder2-3b window 1024", 1, 24, 2, 128, 4096, 1024, BF16, BF16,
     12305),
]
# (label, B, H, Hkv, S, T, D)
FLASH_SHAPES = [("starcoder2-3b prefill", 1, 24, 2, 4096, 4096, 128),
                ("phi4-mini prefill", 1, 24, 8, 2048, 2048, 128)]


def _bind_decode(lib):
    lib.coserve_decode_attention_splits.argtypes = [ctypes.c_int] * 4
    lib.coserve_decode_attention_splits.restype = ctypes.c_int
    fn = lib.coserve_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _bind_flash(lib):
    fn = lib.coserve_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def earlier_decode(lib, q, k, v, pos, window):
    b, h, d = q.shape
    hkv, w = k.shape[1], k.shape[2]
    g = h // hkv
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = lib.coserve_decode_attention_splits(b, hkv, w, sms)
    out = torch.empty_like(q)
    ws = torch.empty(b * hkv * splits * (g * d + 2 * g) if splits > 1 else 0,
                     dtype=torch.float32, device=q.device)
    rc = lib.coserve_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ws.data_ptr() if splits > 1 else None, b, h, hkv, w, d, pos, window,
        int(q.dtype == BF16), int(k.dtype == BF16), splits,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"earlier decode_attention: CUDA error {rc}")
    return out


def earlier_flash(lib, q, k, v):
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    rc = lib.coserve_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv,
        s, t, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], 1, 0, 1, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"earlier flash_attention: CUDA error {rc}")
    return out


def graph_ms(fn, arg_sets) -> float:
    """Mean device time of one call, by replaying a CUDA graph of ITERS
    calls over the rotated ``arg_sets``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*arg_sets[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(ITERS):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def in_turns(earlier, current, arg_sets, check) -> dict:
    """Both against ``check`` (max |err| of each), then timed earlier,
    current, current, earlier."""
    errs = [check(f(*arg_sets[0])) for f in (earlier, current)]
    times = {"earlier": [], "current": []}
    for name in ("earlier", "current", "current", "earlier"):
        times[name].append(graph_ms(earlier if name == "earlier"
                                    else current, arg_sets))
    e_ms, c_ms = (sum(times[n]) / 2 for n in ("earlier", "current"))
    return {"earlier_ms": e_ms, "current_ms": c_ms,
            "earlier_over_current": e_ms / c_ms, "turns_ms": times,
            "earlier_max_abs_err": errs[0], "current_max_abs_err": errs[1]}


def main(argv) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        raise SystemExit("usage: python -m repro_torch.kernels.compare DIR "
                         "(needs a CUDA card)")
    from repro_torch.kernels.ref import (decode_attention_ref,
                                         flash_attention_ref)

    src = Path(argv[0])
    dec = load_library(src / "decode_attention.cu", _bind_decode)
    fl = load_library(src / "flash_attention.cu", _bind_flash)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, b, h, hkv, d, w, window, qt, kvt, pos in DECODE_SHAPES:
        per_set = 2 * b * hkv * w * d * (2 if kvt == BF16 else 4)
        copies = max(1, min(8, math.ceil(2 * L2_BYTES / per_set)))
        sets = [(torch.randn((b, h, d), generator=gen, device=dev).to(qt),
                 *(torch.randn((b, hkv, w, d), generator=gen,
                               device=dev).to(kvt) for _ in range(2)))
                for _ in range(copies)]
        want = decode_attention_ref(*sets[0], pos, window=window).float()
        line = in_turns(
            lambda q, k, v: earlier_decode(dec, q, k, v, pos, window),
            lambda q, k, v: da.decode_attention(q, k, v, pos, window=window),
            sets, lambda out: (out.float() - want).abs().max().item())
        print(json.dumps({"kernel": "decode_attention", "shape": label,
                          "card": card, **line}), flush=True)
    for label, b, h, hkv, s, t, d in FLASH_SHAPES:
        sets = [tuple(torch.randn((b, n, m, d), generator=gen,
                                  device=dev).to(BF16)
                      for n, m in ((h, s), (hkv, t), (hkv, t)))
                for _ in range(2)]
        want = flash_attention_ref(*sets[0]).float()
        line = in_turns(lambda q, k, v: earlier_flash(fl, q, k, v),
                        fa.flash_attention, sets,
                        lambda out: (out.float() - want).abs().max().item())
        print(json.dumps({"kernel": "flash_attention", "shape": label,
                          "card": card, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
