#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which ends the run with a nonzero exit when it fails:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: ``nvcc`` compiles the decode_attention kernel from the checkout;
3. kernel vs plain: the kernel against ``decode_attention_ref`` on the card
   at the serving geometry and at phi4-mini's and starcoder2-3b's attention
   geometry, with its time, its bound, the plain version's time and the time
   of ``scaled_dot_product_attention`` as a library yardstick;
4. the main path: ``repro_torch.launch.serve --mode real --decode`` on the
   card, every decode step through the kernel;
5. the same server with phi4-mini's ring geometry;
6. ``--mode real`` and ``--mode online --engine real`` without decode.

The last two lines of output are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the
# tensor cores (the kernel's arithmetic is float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
L2_BYTES = 50 * 2 ** 20

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:66"

F32, BF16 = torch.float32, torch.bfloat16
# (label, batch, heads, kv heads, head dim, ring width, window, q, kv)
GEOMETRIES = [
    ("engine default", 1, 4, 2, 64, 64, 0, F32, F32),
    ("engine default, batch 2", 2, 4, 2, 64, 64, 0, F32, F32),
    ("phi4-mini bf16", 1, 24, 8, 128, 4096, 0, BF16, BF16),
    ("phi4-mini fp32-q/bf16-kv", 1, 24, 8, 128, 4096, 0, F32, BF16),
    ("starcoder2-3b window 1024", 1, 24, 2, 128, 4096, 1024, BF16, BF16),
]
REPORTED = ("phi4-mini bf16", "3W+17")   # the line the kernels JSON carries
PHI4_RING = dict(num_heads=24, num_kv_heads=8, head_dim=128, width=4096,
                 dtype="bfloat16")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout
    return out.strip().splitlines()[0]


def valid_slots(pos: int, width: int, window: int, device) -> torch.Tensor:
    slots = torch.arange(width, device=device)
    abs_pos = pos - torch.remainder(pos - slots, width)
    valid = abs_pos >= 0
    if window:
        valid &= (pos - abs_pos) < window
    return valid


def time_ms(fn, arg_sets, iters: int, graph: bool = True) -> float:
    """Mean time per call of ``fn`` by CUDA events, rotating over input
    copies so that each call finds its inputs outside the L2 cache where
    they do not all fit in it. With ``graph`` the calls are captured in one
    CUDA graph and replayed, so the time is the device's alone; without it
    the calls are issued from Python and the host's launch cost counts."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_split(fn, args, iters: int = 20) -> dict:
    """Device time per call of each CUDA kernel ``fn`` launches (ms), from
    ``torch.profiler``'s CUDA activity; empty if the tracer saw nothing."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    names = ("decode_attention_kernel", "combine_kernel")
    return {next((n for n in names if n in e.key), e.key[:48]):
            e.device_time_total / iters / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def kernel_vs_plain(da, ref):
    """Phase 3: one line per (geometry, position); returns the lines."""
    import torch.nn.functional as F

    lines = []
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, b, h, hkv, d, w, window, qt, kvt in GEOMETRIES:
        g = h // hkv
        per_set = 2 * b * hkv * w * d * (2 if kvt == BF16 else 4)
        copies = max(1, min(8, math.ceil(2 * L2_BYTES / per_set)))
        sets = [(torch.randn((b, h, d), generator=gen, device=dev).to(qt),
                 torch.randn((b, hkv, w, d), generator=gen,
                             device=dev).to(kvt),
                 torch.randn((b, hkv, w, d), generator=gen,
                             device=dev).to(kvt)) for _ in range(copies)]
        tol = 2e-5 if qt == F32 else 2e-2
        for pos_name, pos in (("0", 0), ("W-1", w - 1), ("W", w),
                              ("3W+17", 3 * w + 17)):
            q, k, v = sets[0]
            got = da.decode_attention(q, k, v, pos, window=window)
            want = ref.decode_attention_ref(q, k, v, pos, window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not torch.allclose(got.float(), want.float(), rtol=tol,
                                  atol=tol):
                raise AssertionError(
                    f"decode_attention disagrees with its plain version at "
                    f"{label}, pos={pos}: max |err| {err} > tol {tol}")
            ms = time_ms(lambda q, k, v: da.decode_attention(
                q, k, v, pos, window=window), sets, 50)
            eager_ms = time_ms(lambda q, k, v: da.decode_attention(
                q, k, v, pos, window=window), sets, 50, graph=False)
            plain_ms = time_ms(lambda q, k, v: ref.decode_attention_ref(
                q, k, v, pos, window=window), sets, 20)
            # library yardstick: SDPA on the GQA-expanded ring with the
            # validity mask (expansion and mask made outside the timing)
            mask = valid_slots(pos, w, window, dev)[None, None, None]
            lib_sets = [(q[:, :, None, :],
                         k.to(qt).repeat_interleave(g, dim=1),
                         v.to(qt).repeat_interleave(g, dim=1))
                        for q, k, v in sets[:max(1, copies // g)]]
            lib_ms = time_ms(lambda q4, ke, ve: F.scaled_dot_product_attention(
                q4, ke, ve, attn_mask=mask), lib_sets, 50)
            lib_out = F.scaled_dot_product_attention(*lib_sets[0],
                                                     attn_mask=mask)[:, :, 0]
            lib_err = (lib_out.float() - want.float()).abs().max().item()
            # bound: the K and V rows the mask lets through, q and out once;
            # 4 operations per (query row, slot, d): the q.k and p.v FMAs
            n_valid = int(mask.sum().item())
            nbytes = (2 * b * hkv * n_valid * d * k.element_size()
                      + 2 * b * h * d * q.element_size())
            ops = 4 * b * h * n_valid * d
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
            line = {"shape": f"{label}: B={b} H={h} Hkv={hkv} D={d} W={w} "
                             f"window={window} pos={pos_name}",
                    "max_abs_err": err, "tol": tol, "ms": ms,
                    "eager_ms": eager_ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "library_max_abs_err": lib_err,
                    "bound_ms": max(t_bytes, t_ops) * 1e3,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "valid_slots": n_valid,
                    "reported": (label, pos_name) == REPORTED}
            line["device_split_ms"] = device_split(
                lambda q, k, v: da.decode_attention(
                    q, k, v, pos, window=window), sets[0])
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


def replay_result(rid: int, tokens: int, ring: dict) -> np.ndarray:
    """The decode result a request must end with: the engine's hash-seeded
    inputs replayed through a CPU ring and the plain version."""
    from repro_torch.core.engines import RingKVCache

    cache = RingKVCache(**ring, device="cpu")
    for _ in range(tokens):
        rng = np.random.default_rng(abs(hash((rid, cache.pos + 1)))
                                    % (2 ** 32))
        hkv, d = cache.num_kv_heads, cache.head_dim
        cache.append(rng.standard_normal((hkv, d)),
                     rng.standard_normal((hkv, d)))
        q = rng.standard_normal((cache.num_heads, d))
    return cache.attend(q)


def serve_decode(serve, da, argv, ring=None):
    """Phases 4 and 5: the real server with decode on the card; the kernel's
    launches in the run must equal its member-steps (one token each)."""
    from repro_torch.api import Session

    spec = serve.spec_from_args(serve.build_parser().parse_args(argv))
    if spec.decode.tokens_dist != "fixed":
        raise AssertionError("the token count check needs fixed lengths")
    expected_tokens = spec.workload.requests * spec.decode.tokens
    if ring is None:
        da.decode_attention.launches = 0
        result = serve.main(argv)
        launches = da.decode_attention.launches
        checked = 0
    else:
        sess = Session(spec, device="cuda")
        sess.system.engine.decode_attn = dict(ring)
        reqs = sess._real_requests()
        sess.submit(reqs)
        da.decode_attention.launches = 0
        result = sess.run()
        launches = da.decode_attention.launches
        # requests that ended on their first expert hold their own decode
        # result: hold a few against the replay on the CPU
        ended = [r for r in reqs if isinstance(r.result, np.ndarray)]
        for r in ended[:6]:
            want = replay_result(r.id, spec.decode.tokens, ring)
            if r.result.shape != want.shape \
                    or not np.isfinite(r.result).all() \
                    or not np.allclose(r.result, want, rtol=2e-5, atol=2e-5):
                raise AssertionError(f"request {r.id}: served decode result "
                                     "disagrees with the CPU replay")
        checked = min(6, len(ended))
    tokens = result["decode"]["tokens_out"]
    summary = {"completed": result["completed"], "tokens_out": tokens,
               "expected_tokens": expected_tokens, "launches": launches,
               "replayed": checked, "makespan_s": result["makespan_s"],
               "token_p50_s": result["decode"]["token"]["p50"]}
    print(json.dumps(summary), flush=True)
    if result["completed"] != spec.workload.requests:
        raise AssertionError(f"{result['completed']} of "
                             f"{spec.workload.requests} requests completed")
    if tokens != expected_tokens:
        raise AssertionError(f"decoded {tokens} tokens, the spec gives "
                             f"{expected_tokens}")
    if not 0 < launches == tokens:
        raise AssertionError(f"{launches} kernel launches for {tokens} "
                             "decode member-steps")
    return launches


def main() -> int:
    t_start = time.perf_counter()
    phase("1 environment")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    from repro_torch.launch import serve

    phase("2 build")
    t0 = time.perf_counter()
    lib = da.build_library()
    print(f"built {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for ln in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print("  ptxas:", ln.strip())

    phase("3 kernel vs plain")
    lines = kernel_vs_plain(da, ref)

    phase("4 serving with decode (the main path)")
    launches = serve_decode(serve, da, ["--mode", "real", "--decode",
                                        "--requests", "40", "--quiet"])

    phase("5 serving with decode, phi4-mini ring geometry")
    serve_decode(serve, da, ["--mode", "real", "--decode", "--requests",
                             "40", "--quiet"], ring=PHI4_RING)

    phase("6 serving without decode")
    for argv in (["--mode", "real", "--requests", "40", "--quiet"],
                 ["--mode", "online", "--engine", "real", "--requests", "60",
                  "--quiet"]):
        result = serve.main(argv)
        want = int(argv[argv.index("--requests") + 1])
        print(json.dumps({"argv": argv, "completed": result["completed"],
                          "makespan_s": result["makespan_s"]}), flush=True)
        if result["completed"] != want:
            raise AssertionError(f"{argv}: {result['completed']} of {want} "
                                 "requests completed")

    rep = next(ln for ln in lines if ln["reported"])
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": [{
        "name": "decode_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
        "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
        "shape": rep["shape"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
