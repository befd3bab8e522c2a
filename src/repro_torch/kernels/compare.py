"""Time the kernels of this checkout against an earlier build of their
sources, in turns, on one CUDA card.

    python -m repro_torch.kernels.compare DIR

``DIR`` holds earlier versions of any of ``decode_attention.cu``,
``flash_attention.cu`` and ``mamba_scan.cu`` (for example ``git show
<commit>:<path>`` of each into a git-ignored directory, or a throwaway
variant of one); a kernel whose file is missing there is skipped. Each is
built with this checkout's flags and called through its own C interface:
PR 13's decode kernel planned its splits in C
(``coserve_decode_attention_splits``) and combined them in a second kernel,
PRs 14-15's kept its combine tickets in the library (no ``tickets``
argument, no ``coserve_decode_attention_max_rows``) and later builds take
them from the caller;
the earlier flash kernel took a bf16 flag where this one takes a route; the
earlier scan's ``coserve_mamba_scan`` has the interface of this checkout's
short route, while the current side is the wrapper, which routes by
``mamba_scan.plan``. At each shape the two builds run earlier, current,
current, earlier, each time by CUDA-graph replay of ``ITERS`` calls over
inputs rotated past the L2 cache, and each line gives both means, their
ratio, the current route and the card.
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
from repro_torch.kernels import mamba_scan as ms
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
# (label, B, S, D, N, x dtype, dt dtype, B/C dtype): chip_smoke.py phase
# 10's shapes, the router's 16-token batches and both sides of the scan's
# crossover (ms.SCAN_MIN_SEQ)
MAMBA_SHAPES = [
    ("falcon-mamba prefill", 1, 4096, 8192, 16, BF16, F32, F32),
    ("fp32 over 4096 steps", 1, 4096, 2048, 16, F32, F32, F32),
    ("ragged fp32", 2, 1000, 1000, 16, F32, F32, F32),
    ("all bf16, state 8", 2, 333, 520, 8, BF16, BF16, BF16),
    *((f"lm router, batch {b}", b, 16, 8192, 16, BF16, F32, F32)
      for b in (1, 2, 4, 8)),
    *((f"crossover S {s}", 1, s, 8192, 16, BF16, F32, F32)
      for s in (ms.SCAN_MIN_SEQ - 1, ms.SCAN_MIN_SEQ)),
]


def _decode_interface(lib) -> str:
    """Which C interface an earlier decode library has: "splits" (PR 13),
    "library tickets" (PRs 14-15) or "caller tickets"."""
    if hasattr(lib, "coserve_decode_attention_splits"):
        return "splits"
    if hasattr(lib, "coserve_decode_attention_max_rows"):
        return "caller tickets"
    return "library tickets"


def _bind_decode(lib):
    fn = lib.coserve_decode_attention
    kind = _decode_interface(lib)
    if kind == "splits":
        lib.coserve_decode_attention_splits.argtypes = [ctypes.c_int] * 4
        lib.coserve_decode_attention_splits.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
    else:
        pointers = 6 if kind == "caller tickets" else 5
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _bind_flash(lib):
    fn = lib.coserve_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _bind_mamba(lib):
    names = ["coserve_mamba_scan"]
    if hasattr(lib, "coserve_mamba_scan_chunked"):
        names.append("coserve_mamba_scan_chunked")
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 8 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int


def earlier_mamba(lib, x, dt, b_mat, c_mat, a, d_vec):
    """The earlier build's scan: its chunked kernel where it has one and
    this checkout's plan picks that route, else its one kernel."""
    bsz, s, d = x.shape
    n = b_mat.shape[-1]
    y = torch.empty_like(x)
    h = torch.empty((bsz, d, n), dtype=F32, device=x.device)
    chunked = hasattr(lib, "coserve_mamba_scan_chunked") and ms.plan(
        bsz, s, d, n, ms.rows_aligned(x, dt))["route"] == "chunked"
    fn = lib.coserve_mamba_scan_chunked if chunked else lib.coserve_mamba_scan
    rc = fn(
        x.data_ptr(), dt.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
        a.data_ptr(), d_vec.data_ptr(), y.data_ptr(), h.data_ptr(), bsz, s, d,
        n, *x.stride()[:2], *dt.stride()[:2], *b_mat.stride()[:2],
        *c_mat.stride()[:2], int(x.dtype == BF16), int(dt.dtype == BF16),
        int(b_mat.dtype == BF16), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"earlier mamba_scan: CUDA error {rc}")
    return y, h


_earlier_tickets = {}


def earlier_decode(lib, q, k, v, pos, window):
    """The earlier build's decode kernel through its own interface; a build
    that takes its tickets from the caller gets one zeroed array of its
    own (this module's calls run one after another)."""
    b, h, d = q.shape
    hkv, w = k.shape[1], k.shape[2]
    g = h // hkv
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    flags = (int(q.dtype == BF16), int(k.dtype == BF16))
    out = torch.empty_like(q)
    kind = _decode_interface(lib)
    if kind == "splits":
        splits = lib.coserve_decode_attention_splits(b, hkv, w, sms)
        ws = torch.empty(b * hkv * splits * (g * d + 2 * g)
                         if splits > 1 else 0, dtype=F32, device=q.device)
        rc = lib.coserve_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ws.data_ptr() if splits > 1 else None, b, h, hkv, w, d, pos,
            window, *flags, splits, stream)
    else:
        tile, rows, splits = da.plan(b, hkv, w, d, g, k.element_size(), sms)
        ws = torch.empty(b * hkv * -(-g // rows) * splits
                         * (rows * d + 2 * rows) if splits > 1 else 0,
                         dtype=F32, device=q.device)
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ws.data_ptr() if splits > 1 else None]
        if kind == "caller tickets":
            if id(lib) not in _earlier_tickets:
                _earlier_tickets[id(lib)] = torch.zeros(
                    da.MAX_ROWS, dtype=torch.int32, device=q.device)
            ptrs.append(_earlier_tickets[id(lib)].data_ptr())
        rc = lib.coserve_decode_attention(
            *ptrs, b, h, hkv, w, d, pos, window, *flags, tile, rows, splits,
            stream)
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
    src = Path(argv[0])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, run in (("decode_attention", compare_decode),
                      ("flash_attention", compare_flash),
                      ("mamba_scan", compare_mamba)):
        if (src / f"{name}.cu").exists():
            run(src / f"{name}.cu", card, gen)
    return 0


def compare_decode(source, card, gen):
    from repro_torch.kernels.ref import decode_attention_ref

    dec = load_library(source, _bind_decode)
    dev = torch.device("cuda")
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


def compare_flash(source, card, gen):
    from repro_torch.kernels.ref import flash_attention_ref

    fl = load_library(source, _bind_flash)
    dev = torch.device("cuda")
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


def compare_mamba(source, card, gen):
    """Inputs as chip_smoke.py phase 10 draws them: dt a softplus, A
    negative; the error is the larger of y's and h's max |err| against
    the plain version."""
    from repro_torch.kernels.ref import mamba_scan_ref

    lib = load_library(source, _bind_mamba)
    dev = torch.device("cuda")
    size = lambda t: 2 if t == BF16 else 4
    for label, b, s, d, n, xt, dtt, bct in MAMBA_SHAPES:
        per_set = b * s * d * (2 * size(xt) + size(dtt)) \
            + 2 * b * s * n * size(bct)
        copies = max(1, min(8, math.ceil(2 * L2_BYTES / per_set)))
        randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
        a, d_vec = -torch.exp(randn(d, n)), randn(d)
        sets = [(randn(b, s, d).to(xt),
                 torch.nn.functional.softplus(randn(b, s, d)).to(dtt),
                 randn(b, s, n).to(bct), randn(b, s, n).to(bct), a, d_vec)
                for _ in range(copies)]
        want_y, want_h = mamba_scan_ref(*sets[0])

        def err(out):
            return max((out[0].float() - want_y.float()).abs().max().item(),
                       (out[1] - want_h).abs().max().item())

        line = in_turns(lambda *args: earlier_mamba(lib, *args),
                        ms.mamba_scan, sets, err)
        print(json.dumps({"kernel": "mamba_scan", "shape": label,
                          "route": ms.plan(b, s, d, n)["route"],
                          "earlier": str(source), "card": card, **line}),
              flush=True)
        del sets, want_y, want_h
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
