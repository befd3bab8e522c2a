#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which ends the run with a nonzero exit when it fails:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: ``nvcc`` compiles every kernel of the port from the checkout,
   one compiler per source, all started together;
3. decode kernel vs plain: ``decode_attention`` against
   ``decode_attention_ref`` on the card at the serving geometry, a ring of
   two splits, phi4-mini's and starcoder2-3b's attention geometry and the
   rings the transformer's, Moonlight's, Jamba's and Whisper's decode
   steps use, with its time, its bound, the plain version's time, the time
   of ``scaled_dot_product_attention`` as a library yardstick and the
   profiler's kernels a call (one: the splits combine in the same launch);
   then calls with splits in flight on two streams at once, each held
   against the plain version (each stream has its own combine tickets);
4. serving with decode: ``repro_torch.launch.serve --mode real --decode``
   on the card, every decode step through the decode kernel;
5. the same server with phi4-mini's ring geometry;
6. ``--mode real`` and ``--mode online --engine real`` without decode,
   and ``repro_torch.launch.serve_real_experts`` (the twin of the JAX
   package's serving example: 150 requests under COSERVE and
   SAMBA_PARALLEL, every one completed);
7. flash kernel vs plain: ``flash_attention`` against
   ``flash_attention_ref`` at starcoder2-3b's, phi4-mini's and Moonlight's
   prefill, a cached prefix, a sliding window, a ragged fp32 case, a
   non-causal one, phase 9's 16-token batches in the layout the model hands
   it, query lengths around the bf16 dispatch's crossover and Whisper's
   non-causal shapes (its encoder over 1500 frames, its cross-attention of
   a 64-token prompt and of one decode token over them), with the same
   timings and SDPA as the yardstick; where both bf16 kernels take the
   shape, each is held against the plain version and the two are timed in
   turns;
7b. the norm and RoPE kernels (no TPU counterpart): ``add_norm`` and
   ``rope`` against their plain chains at the benchmark cells' shapes,
   each timed alone (graph replay and issued from Python) beside its byte
   bound, the plain chain and ``F.layer_norm`` / ``F.rms_norm``; phases
   8, 9, 11-15 count their launches on the main paths (a norm before each
   mixer and each feed-forward and a final one, a RoPE each attention
   layer, every forward), and the kernels JSON sums those counts;
8. the transformer at StarCoder2-3B's full width: (a) 2 layers in float32,
   the kernels' path against the plain-torch path and greedy generation
   against teacher forcing; (b) all 30 layers with bf16 weights, a
   4096-token prefill and 32 decode steps, timed and profiled;
9. the LM-expert router (``repro_torch.launch.lm_coe_router``) at full
   width with its depth cut to 2 layers: 90 prompts under both policies,
   every expert forward through the flash kernel, and every served forward
   run again through the plain-torch attention path to compare;
10. scan kernel vs plain: ``mamba_scan`` against ``mamba_scan_ref`` at
   Falcon-Mamba-7B's prefill (B 1, S 4096, D 8192, N 16, x bf16, dt B C
   float32), float32 over 4096 steps, a ragged float32 case, an all-bf16
   one with the smoke configs' state of 8, phase 12's 16-token batches and
   sequence lengths on each side of the route crossover (``SCAN_MIN_SEQ``),
   with the route ``plan`` picks, the kernel's time, its bound and the
   plain version's time (no single PyTorch call computes a selective scan:
   no library yardstick), the profiler's kernels a call (one, at the
   prefill and at the router's batch of one), and, where both kernels take
   the shape, each held against the plain version and the two timed in
   turns;
11. Falcon-Mamba-7B at its published width: (a) 2 layers in float32, the
   kernel path against the plain-torch scan and greedy generation against
   teacher forcing; (b) all 64 layers with bf16 weights, a 4096-token
   prefill and 32 decode steps, timed and profiled; every prefill's scans
   on the chunked kernel;
12. the LM-expert router with ``--arch falcon_mamba_7b`` at full width, 2
   layers: 90 prompts under both policies, every expert forward's scan
   through the sequential kernel, every served forward run again through
   the plain-torch scan to compare;
13. Moonlight-16B-A3B (64 experts, top-6) at its published width: (a) 2
   layers in float32 at a dropless capacity factor, the kernels' path
   against the plain-torch path and greedy generation against teacher
   forcing, then the tokens a 4096-token prompt drops at the published
   1.25 and the expert load; (b) all 48 layers with bf16 weights, a
   4096-token prefill and 32 decode steps, timed and profiled by family
   (flash, decode kernel, MoE expert matmuls, MoE routing, dispatch and
   combine, the rest);
14. Jamba-v0.1 with its MoE (16 experts, top-2, on odd slots): (a) one
   period (8 layers) in float32, B 1, 512 tokens, kernels' path against
   plain path; (b) two periods (16 layers, the depth cut so the bf16
   weights fit one card) the same way as 13(b): the one model whose
   forward runs all three kernels;
14c. a Jamba2-Mini stage (ai21labs/AI21-Jamba2-Mini: 8 of 32 layers,
   experts 0-7 of each MoE layer's 16 held, dropless top-2 without
   renormalising, no RoPE, the mixer's dt, B and C norms) at full width in
   bf16, B 8 x S 128: ``moe_grouped`` against its plain version
   (``moe_grouped_ref``) on the arguments a forward's first MoE layer hands
   it, timed beside its bound, the plain version and a per-expert
   ``torch.matmul`` loop that reads the counts on the host (the library
   yardstick); the forward's launches counted from 0 (8 ``moe_grouped``, 7
   ``mamba_scan``, 1 ``flash_attention``, 38 ``add_norm``: 17 norms of the
   residual stream and 21 of the mixers' dt, B and C; no ``rope``);
   then the forward timed with the kernel and with that loop in its place,
   in turns;
15. the LM-expert router with ``--arch moonshot_v1_16b_a3b`` at full
   width, 2 layers (1 if the host has under 40 GB free for the store): 90
   prompts under both policies, flash launches = layers x forwards, every
   served forward run again through the plain-torch path, rows whose
   routing took other experts on the two paths at a near-tie counted and
   set aside;
16. Whisper-medium: (a) 2 encoder and 2 decoder layers in float32, the
   kernels' path against the plain-torch path and prefill + decode steps
   against the teacher-forced decoder; (b) all 24 + 24 layers in bf16,
   B 1, 1500 frames, a 64-token prompt and 32 decode steps: encode,
   prefill and decode timed and profiled by family;
17. training (``repro_torch.training``, the plain torch paths: the kernels
   have no backward): (a) one ``make_train_step`` step of StarCoder2-3B at
   full width, 2 layers, float32, B 2 x S 64, on the card (TF32 off) and
   on the host from the same weights, loss, grad norm and every gradient
   leaf compared; (b) StarCoder2-3B whole (30 layers, float32 params, bf16
   compute, remat) for 6 steps at B 1 x S 4096 on one repeated batch: the
   state's bytes, peak memory (and the memory allocated just before the
   steps), wall, device and optimizer ms a step, tokens/s and 6NT
   utilisation, the loss falling, then one more step under the dry run's
   counter (``dryrun.trace_step`` on the card's tensors); (c) Whisper-medium
   whole, B 2, 1500 frames, 448 tokens, 4 steps; (d) Moonlight-16B-A3B at
   full width cut to 2 layers, B 1 x S 4096, 3 steps, aux loss positive;
   (e) ``repro_torch.launch.train_100m`` (300 steps, checkpoints every
   50), ``launch.train --resume`` to step 360 from its checkpoint, and 60
   steps with int8 error-feedback gradients, each with its tokens/s;
   (f) ``flash_attention_op`` with an input that requires grad, and a
   train step with ``attn_impl="pallas"``, both refused; (g) one step of
   Falcon-Mamba-7B at full width, 2 layers, float32, card against host as
   in (a), the scan the plain path's chunked scan (``models/ssm.py``);
   (h) Falcon-Mamba-7B at full width cut to 32 of 64 layers (float32
   params, grads and moments) for 4 steps at B 1 x S 4096 as in (b), then one
   Mamba layer's forward + backward at S 4096 through the chunked scan
   and through the stepped recurrence the plain path ran before it;
18. the dry run (``repro_torch.launch.dryrun``, meta DTensors over a fake
   process group of 512 ranks, no card): StarCoder2-3B x train_4k,
   Falcon-Mamba-7B x prefill_32k, Mixtral-8x22B x train_4k,
   Whisper-medium x decode_32k, Minitron-8B x train_4k and Minitron-8B x
   prefill_32k on 16x16, StarCoder2-3B x decode_32k on 2x16x16, each cell
   in a process of its own, all started with phase 17 on the host's
   cores; one JSON line a cell (trace seconds, flops per device, argument,
   peak and temp bytes, bytes accessed, collective bytes by kind, DTensor's
   implicit redistributions included, the mesh's type), then one line of
   each cell's collective bytes by kind; a cell failing whose peak or bytes
   accessed is null, whose peak is over one H100's 80 GB, whose mesh is not
   ``"cuda"``-typed as a card run's is (on a ``"cpu"`` mesh DTensor gathers
   a whole dim where the cards would move a shard by all-to-all), whose
   process started CUDA, or (StarCoder2-3B x train_4k) whose flops a
   device exceed 130 T, whose all-gather exceeds 100 GB a device or which
   counts no all-to-all;
19. the local mesh on the card: StarCoder2-3B at full width, 2 layers,
   float32, one train step with its parameters as DTensors on
   ``make_local_mesh()`` (NCCL, one rank) under the train rules, against
   the plain step on the card, held as in 17(a); in a process of its own;
20. the dry run's memory against the card: 17(b)'s and 17(h)'s train
   steps traced by ``dryrun.trace_step`` on meta tensors of the card
   run's shapes and dtypes (``chip_smoke.py --meta-train-peaks OUT``, a
   process of its own on the host's CPU, started with phase 18); each
   traced ``peak_bytes`` held within 5% of the card's peak for those steps
   (``max_memory_allocated()`` less what was allocated before them that is
   not one of their arguments), and 17(b)'s live count on the card beside
   them, held the same way.

Phase 11(a)'s plain path is the chunked scan since the sixth slice.

The last two lines of output are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels.mamba_scan import SCAN_MIN_SEQ  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the
# tensor cores (the kernel's arithmetic is float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
L2_BYTES = 50 * 2 ** 20

BF16_OPS_PER_S = 989e12       # dense bf16 on the tensor cores

DECODE_SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
DECODE_REPLACES = "src/repro/kernels/decode_attention.py:66"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:84"
MAMBA_SOURCE = "src/repro_torch/kernels/csrc/mamba_scan.cu"
MAMBA_REPLACES = "src/repro/kernels/mamba_scan.py:63"
MOE_SOURCE = "src/repro_torch/kernels/csrc/moe_grouped.cu"
MOE_REPLACES = ("none: the JAX package's MoE layer is plain jnp over a "
                "capacity buffer, which XLA compiles")
ADD_NORM_SOURCE = "src/repro_torch/kernels/csrc/add_norm.cu"
ROPE_SOURCE = "src/repro_torch/kernels/csrc/rope.cu"
NO_TPU_KERNEL = "none: XLA fuses the chain on the TPU"
# the exponentials' own rate on the SFUs, beside the bound: 16 a clock per
# SM (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0), 132 SMs, the H100 SXM's 1.98 GHz boost clock
SFU_EXP_PER_S = 16 * 132 * 1.98e9

F32, BF16 = torch.float32, torch.bfloat16
# (label, batch, heads, kv heads, head dim, ring width, window, q, kv)
GEOMETRIES = [
    ("engine default", 1, 4, 2, 64, 64, 0, F32, F32),
    ("engine default, batch 2", 2, 4, 2, 64, 64, 0, F32, F32),
    ("phi4-mini bf16", 1, 24, 8, 128, 4096, 0, BF16, BF16),
    ("phi4-mini fp32-q/bf16-kv", 1, 24, 8, 128, 4096, 0, F32, BF16),
    ("starcoder2-3b window 1024", 1, 24, 2, 128, 4096, 1024, BF16, BF16),
    # the rings of phase 8: (b) 4096 + 32 tokens in bf16, (a) 512 + 16 fp32
    ("starcoder2-3b decode bf16", 1, 24, 2, 128, 4128, 0, BF16, BF16),
    ("starcoder2-3b decode fp32, batch 2", 2, 24, 2, 128, 528, 0, F32, F32),
    # the smallest ring the wrapper splits in two (three 64-slot tiles)
    ("engine heads, two splits", 1, 4, 2, 64, 192, 0, F32, F32),
    # the rings of the whole-model runs of phases 13(b), 14(b) and 16(b)
    ("moonlight decode bf16", 1, 16, 16, 128, 4128, 0, BF16, BF16),
    ("jamba attention decode bf16", 1, 32, 8, 128, 4128, 0, BF16, BF16),
    ("whisper decoder self-attention bf16", 1, 16, 16, 64, 96, 0, BF16,
     BF16),
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


def device_split(fn, args, names, iters: int = 20) -> dict:
    """Device time per call of each CUDA kernel ``fn`` launches (ms), from
    ``torch.profiler``'s CUDA activity, keyed by the first of ``names`` the
    kernel's name holds; empty if the tracer saw nothing."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
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
            line["plan"] = dict(zip(("tile", "rows", "splits"), da.plan(
                b, hkv, w, d, g, k.element_size(),
                torch.cuda.get_device_properties(dev).multi_processor_count)))
            line["device_split_ms"] = split = device_split(
                lambda q, k, v: da.decode_attention(
                    q, k, v, pos, window=window), sets[0],
                ("decode_attention_kernel",))
            print(json.dumps(line), flush=True)
            if split and list(split) != ["decode_attention_kernel"]:
                raise AssertionError(f"decode_attention at {label} ran "
                                     f"{list(split)}, not one kernel a call")
            lines.append(line)
    return lines


def two_streams(da, ref, calls: int = 40) -> dict:
    """Phase 3's concurrency check: phi4-mini's bf16 ring (32 splits) on two
    streams, ``calls`` calls each issued in turns with no wait between
    them, each stream on its own inputs; every result against the plain
    version. Calls that shared one set of combine tickets would draw each
    other's and combine early or not at all."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    b, h, hkv, d, w = 1, 24, 8, 128, 4096
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = da.plan(b, hkv, w, d, h // hkv, 2, sms)[2]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    inputs = [(torch.randn((b, h, d), generator=gen, device=dev).to(BF16),
               torch.randn((b, hkv, w, d), generator=gen, device=dev).to(BF16),
               torch.randn((b, hkv, w, d), generator=gen, device=dev).to(BF16))
              for _ in streams]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for i in range(calls):
        for j, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[j].append(da.decode_attention(*inputs[j], 3 * w + i))
    torch.cuda.synchronize()
    err = 0.0
    for j in range(2):
        for i, got in enumerate(outs[j]):
            want = ref.decode_attention_ref(*inputs[j], 3 * w + i)
            err = max(err, (got.float() - want.float()).abs().max().item())
            if not torch.allclose(got.float(), want.float(), rtol=2e-2,
                                  atol=2e-2):
                raise AssertionError(
                    f"decode_attention on stream {j}, call {i}: max |err| "
                    f"{err} against the plain version with another stream's "
                    "calls in flight")
    line = {"check": "two streams in flight", "splits": splits,
            "calls_per_stream": calls, "max_abs_err": err, "tol": 2e-2}
    print(json.dumps(line), flush=True)
    return line


def two_graphs(da, ref, calls: int = 4, replays: int = 20) -> dict:
    """Phase 3's graph check: two graphs captured on the default capture
    stream, each holding ``calls`` calls at phi4-mini's bf16 ring (32
    splits) on its own inputs, replayed second first, then in turns, then
    ``replays`` times each on two streams at once; every result against
    the plain version. Graphs that shared one set of combine tickets would
    find them unzeroed, or draw each other's."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    b, h, hkv, d, w = 1, 24, 8, 128, 4096
    inputs = [(torch.randn((b, h, d), generator=gen, device=dev).to(BF16),
               torch.randn((b, hkv, w, d), generator=gen, device=dev).to(BF16),
               torch.randn((b, hkv, w, d), generator=gen, device=dev).to(BF16))
              for _ in range(2)]
    graphs, outs = [], []
    for i in range(2):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append([da.decode_attention(*inputs[i], 3 * w + j)
                         for j in range(calls)])
        graphs.append(graph)
    want = [[ref.decode_attention_ref(*inputs[i], 3 * w + j)
             for j in range(calls)] for i in range(2)]
    err = 0.0

    def check(graphs_run, when):
        nonlocal err
        torch.cuda.synchronize()
        for i in graphs_run:
            for j, (got, ref_out) in enumerate(zip(outs[i], want[i])):
                e = (got.float() - ref_out.float()).abs().max().item()
                err = max(err, e)
                if not torch.allclose(got.float(), ref_out.float(),
                                      rtol=2e-2, atol=2e-2):
                    raise AssertionError(
                        f"decode_attention in graph {i}, call {j}, {when}: "
                        f"max |err| {e} against the plain version")

    for i in (1, 0, 1, 0):
        graphs[i].replay()
        check((i,), f"replay of graph {i}")
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(replays):
        for graph, s in zip(graphs, streams):
            with torch.cuda.stream(s):
                graph.replay()
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    check((0, 1), "after replays on two streams at once")
    line = {"check": "two graphs, second replayed first, then together",
            "calls_per_graph": calls, "replays_together": replays,
            "max_abs_err": err, "tol": 2e-2}
    print(json.dumps(line), flush=True)
    del graphs
    return line


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


def build_all():
    """Phase 2: one nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import add_norm as an
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import moe_grouped as mg
    from repro_torch.kernels import rope as rp

    t0 = time.perf_counter()
    sources = (da.SOURCE, fa.SOURCE, ms.SOURCE, an.SOURCE, rp.SOURCE,
               mg.SOURCE)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        libs = list(pool.map(build.build_library, sources))
    print(f"built {', '.join(os.path.relpath(p, ROOT) for p in libs)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for lib in libs:
        for ln in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                print("  ptxas:", ln.strip())


# (label, batch, heads, kv heads, S, T, head dim, dtype, causal, window,
#  layout); layout "bshd" hands the kernel [B,H,S,D] views of [B,S,H,D]
# tensors, as attention_block does
FLASH_GEOMETRIES = [
    ("starcoder2-3b prefill", 1, 24, 2, 4096, 4096, 128, BF16, True, 0,
     "bhsd"),
    ("phi4-mini prefill", 1, 24, 8, 2048, 2048, 128, BF16, True, 0, "bhsd"),
    ("cached prefix", 2, 24, 2, 512, 4096, 128, BF16, True, 0, "bhsd"),
    ("sliding window 1024", 1, 24, 2, 4096, 4096, 128, BF16, True, 1024,
     "bhsd"),
    ("ragged fp32", 2, 12, 2, 1000, 1000, 128, F32, True, 0, "bhsd"),
    ("non-causal fp32", 1, 4, 4, 384, 384, 64, F32, False, 0, "bhsd"),
    # phase 9's forwards: 16-token prompts in batches padded to 1/2/4/8
    *((f"lm router, batch {b}", b, 24, 2, 16, 16, 128, BF16, True, 0,
       "bshd") for b in (1, 2, 4, 8)),
    # query lengths around the bf16 dispatch's crossover (WGMMA_MIN_SEQ)
    *((f"crossover S {s}", 1, 24, 2, s, s, 128, BF16, True, 0, "bshd")
      for s in (64, 65, 96, 127, 256, 512)),
    ("crossover S 256, D 64", 1, 24, 2, 256, 256, 64, BF16, True, 0, "bshd"),
    # phase 13(b)'s prefill; phase 16's non-causal shapes: the encoder over
    # 1500 frames (11 tiles of 128 rows and a ragged 92) and the decoder's
    # cross-attention of a 64-token prompt and of a decode step
    ("moonlight prefill", 1, 16, 16, 4096, 4096, 128, BF16, True, 0,
     "bshd"),
    ("whisper encoder", 1, 16, 16, 1500, 1500, 64, BF16, False, 0, "bshd"),
    ("whisper cross-attention, prompt", 1, 16, 16, 64, 1500, 64, BF16,
     False, 0, "bshd"),
    ("whisper cross-attention, decode step", 1, 16, 16, 1, 1500, 64, BF16,
     False, 0, "bshd"),
]
FLASH_REPORTED = "starcoder2-3b prefill"


def visible_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """The (query row, key) pairs the mask lets through: row i sits at
    position t - s + i."""
    qpos = np.arange(s) + (t - s)
    hi = qpos + 1 if causal else np.full(s, t)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(s, int)
    return int(np.maximum(hi - lo, 0).sum())


def flash_vs_plain(fa, ref):
    """Phase 7: one line per geometry; returns the lines."""
    import torch.nn.functional as F

    lines = []
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for (label, b, h, hkv, s, t, d, dt, causal, window,
         layout) in FLASH_GEOMETRIES:
        per_set = (2 * b * h * s * d + 2 * b * hkv * t * d) * (
            2 if dt == BF16 else 4)
        copies = max(1, min(8, math.ceil(2 * L2_BYTES / per_set)))

        def draw(bb, hh, ss):
            if layout == "bshd":
                return torch.randn((bb, ss, hh, d), generator=gen,
                                   device=dev).to(dt).transpose(1, 2)
            return torch.randn((bb, hh, ss, d), generator=gen,
                               device=dev).to(dt)

        sets = [(draw(b, h, s), draw(b, hkv, t), draw(b, hkv, t))
                for _ in range(copies)]
        tol = 2e-5 if dt == F32 else 2e-2
        q, k, v = sets[0]
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            raise AssertionError(
                f"flash_attention disagrees with its plain version at "
                f"{label}: max |err| {err} > tol {tol}")

        def kernel(q, k, v):
            return fa.flash_attention(q, k, v, causal=causal, window=window)

        def plain(q, k, v):
            return ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)

        ms = time_ms(kernel, sets, 20)
        eager_ms = time_ms(kernel, sets, 20, graph=False)
        plain_ms = time_ms(plain, sets[:1], 3)
        # where both bf16 kernels take the shape: each against the plain
        # version, then timed in turns (mma, wgmma, wgmma, mma)
        kernels_ms, kernels_err = {}, {}
        if dt == BF16 and d in fa.WGMMA_HEAD_DIMS:
            for name in ("mma", "wgmma"):
                out = fa.launch(q, k, v, causal=causal, window=window,
                                kernel=name)
                kernels_err[name] = (out.float()
                                     - want.float()).abs().max().item()
                if not torch.allclose(out.float(), want.float(), rtol=tol,
                                      atol=tol):
                    raise AssertionError(
                        f"flash_attention's {name} kernel disagrees with the "
                        f"plain version at {label}: max |err| "
                        f"{kernels_err[name]} > tol {tol}")
            for name in ("mma", "wgmma", "wgmma", "mma"):
                kernels_ms.setdefault(name, []).append(time_ms(
                    lambda q, k, v, name=name: fa.launch(
                        q, k, v, causal=causal, window=window, kernel=name),
                    sets, 20))
        # library yardstick: SDPA, causal by its own flag when S = T and
        # there is no window, else with the boolean mask made outside the
        # timing
        if causal and not window and s == t:
            kw = dict(is_causal=True)
        elif not causal and not window:
            kw = {}
        else:
            qp = torch.arange(s, device=dev)[:, None] + (t - s)
            kp = torch.arange(t, device=dev)[None, :]
            mask = torch.ones((s, t), dtype=torch.bool, device=dev)
            if causal:
                mask &= qp >= kp
            if window:
                mask &= (qp - kp) < window
            kw = dict(attn_mask=mask)

        def library(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **kw)

        lib_ms = time_ms(library, sets, 20)
        lib_err = (library(q, k, v).float() - want.float()).abs().max().item()
        pairs = visible_pairs(s, t, causal, window)
        nbytes = (2 * b * h * s * d + 2 * b * hkv * t * d) * q.element_size()
        ops = 4 * b * h * d * pairs
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = ops / (BF16_OPS_PER_S if dt == BF16 else FP32_OPS_PER_S)
        line = {"shape": f"{label}: B={b} H={h} Hkv={hkv} S={s} T={t} D={d} "
                         f"{'bf16' if dt == BF16 else 'fp32'} causal={causal} "
                         f"window={window} layout={layout}",
                "max_abs_err": err, "tol": tol, "ms": ms,
                "eager_ms": eager_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "library_max_abs_err": lib_err,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "visible_pairs": pairs,
                "tflops": ops / (ms * 1e-3) / 1e12,
                "route": fa.route(s, d, dt),
                "kernels_in_turns_ms": kernels_ms,
                "kernels_max_abs_err": kernels_err,
                "reported": label == FLASH_REPORTED}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del sets, got, want
        torch.cuda.empty_cache()
    return lines


def ulp_check(got, want) -> tuple:
    """(the widest gap between two tensors of one dtype in units in the
    last place, the values more than one unit off and further than 1e-6 of
    their row's RMS): two float32 sums of a row in two orders move a result
    near zero (a cancellation) by more than its own last place."""
    bits = {BF16: (torch.int16, 0x7FFF), F32: (torch.int32, 0x7FFFFFFF)}
    kind, mask = bits[got.dtype]

    def place(t):
        i = t.contiguous().view(kind).long()
        return torch.where(i < 0, -(i & mask), i & mask)

    ulps = (place(got) - place(want)).abs()
    rms = want.float().pow(2).mean(-1, keepdim=True).sqrt()
    off = (ulps > 1) & ((got.float() - want.float()).abs() > 1e-6 * rms)
    return int(ulps.max()), int(off.sum())


# (label, shape, norm type, with delta): the cells' forwards, 8 prompts of
# 128 tokens: StarCoder2-3B's second LayerNorm (after the attention's
# residual) and Falcon-Mamba-7B's RMSNorm; then a batch of one
NORM_GEOMETRIES = [
    ("starcoder2-3b layernorm + residual", (8, 128, 3072), "layernorm",
     True),
    ("falcon-mamba-7b rmsnorm", (8, 128, 4096), "rmsnorm", False),
    ("starcoder2-3b layernorm, batch 1", (1, 128, 3072), "layernorm", False),
]
# (label, batch, seq, query heads, kv heads, head dim, first position)
ROPE_GEOMETRIES = [
    ("starcoder2-3b q and k", 8, 128, 24, 2, 128, 0),
    ("starcoder2-3b decode step", 8, 1, 24, 2, 128, 4095),
]
ROPE_THETA = 999999.4420358813        # StarCoder2-3B's


def norm_rope_vs_plain(an, rp, ref) -> tuple:
    """Phase 7b: the norm and RoPE kernels (no TPU counterpart) at the
    benchmark cells' shapes in bf16, each against its plain chain (the
    widest gap in bf16 units in the last place), timed alone (a CUDA graph's
    replay: device time; and issued from Python: the host's cost counts)
    beside its byte bound and the plain chain timed both ways, with
    ``F.layer_norm`` / ``F.rms_norm`` as a library yardstick (the port
    never calls them). Returns (norm lines, rope lines)."""
    import torch.nn.functional as F

    from repro_torch.models.layers import _rope_table

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(BF16)

    norm_lines = []
    for label, shape, norm_type, with_delta in NORM_GEOMETRIES:
        d = shape[-1]
        layer = norm_type == "layernorm"
        per_set = math.prod(shape) * 2 * (4 if with_delta else 2)
        copies = max(1, min(8, math.ceil(2 * L2_BYTES / per_set)))
        scale, bias = randn(d, scale=0.2) + 1, randn(d, scale=0.2)
        sets = [(randn(*shape), randn(*shape, scale=0.5) if with_delta
                 else None) for _ in range(copies)]
        kw = dict(norm_type=norm_type, eps=1e-5)
        b_ = bias if layer else None

        def kernel(x, delta):
            return an.add_norm(x, scale, b_, delta, **kw)

        def plain(x, delta):
            return ref.add_norm_ref(x, scale, b_, delta, **kw)

        def library(x, delta):
            s = x if delta is None else x + delta
            if layer:
                return F.layer_norm(s, (d,), scale, bias, 1e-5)
            return F.rms_norm(s, (d,), scale, 1e-5)

        x, delta = sets[0]
        got_s, got = kernel(x, delta)
        want_s, want = plain(x, delta)
        torch.cuda.synchronize()
        if not torch.equal(got_s, want_s):
            raise AssertionError(f"add_norm's residual sum differs from the "
                                 f"plain chain's at {label}")
        ulps, off = ulp_check(got, want)
        gap = (got.float() - want.float()).abs().max().item()
        if off:
            raise AssertionError(f"add_norm disagrees with its plain chain at "
                                 f"{label}: {off} values over one ulp "
                                 f"(widest {ulps}), max |err| {gap}")
        nbytes = math.prod(shape) * 2 * (4 if with_delta else 2)
        line = {"kernel": "add_norm",
                "shape": f"{label}: {list(shape)} bf16 {norm_type} "
                         f"delta={with_delta}",
                "max_ulps": ulps, "max_abs_err": gap,
                "equal_share": float((got == want).float().mean()),
                "ms": time_ms(kernel, sets, 50),
                "eager_ms": time_ms(kernel, sets, 50, graph=False),
                "plain_ms": time_ms(plain, sets, 20),
                "plain_eager_ms": time_ms(plain, sets, 20, graph=False),
                "library_ms": time_ms(library, sets, 50),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "reported": not norm_lines}
        print(json.dumps(line), flush=True)
        norm_lines.append(line)
        del sets
    rope_lines = []
    for label, b, s, hq, hkv, hd, first in ROPE_GEOMETRIES:
        freqs = _rope_table(hd, ROPE_THETA, (), dev)
        pos = (first + torch.arange(s, device=dev))[None].expand(b, s)
        per_set = b * s * (hq + hkv) * hd * 2 * 2
        copies = max(1, min(8, math.ceil(2 * L2_BYTES / per_set)))
        sets = [(randn(b, s, hq, hd), randn(b, s, hkv, hd))
                for _ in range(copies)]

        def kernel(q, k):
            return rp.rope(q, k, pos, freqs)

        def plain(q, k):
            return ref.rope_ref(q, k, pos, freqs)

        q, k = sets[0]
        want_q, want_k = plain(q, k)
        got_q, got_k = kernel(q.clone(), k.clone())
        torch.cuda.synchronize()
        (uq, oq), (uk, ok) = ulp_check(got_q, want_q), ulp_check(got_k,
                                                                   want_k)
        ulps, off = max(uq, uk), oq + ok
        gap = max((got_q.float() - want_q.float()).abs().max().item(),
                  (got_k.float() - want_k.float()).abs().max().item())
        if off:
            raise AssertionError(f"rope disagrees with its plain chain at "
                                 f"{label}: {off} values over one ulp "
                                 f"(widest {ulps}), max |err| {gap}")
        equal = float(torch.cat([(got_q == want_q).flatten(),
                                 (got_k == want_k).flatten()]).float()
                      .mean())
        # in place: the timed calls rotate the copies again and again
        line = {"kernel": "rope",
                "shape": f"{label}: q [{b},{s},{hq},{hd}] k [{b},{s},{hkv},"
                         f"{hd}] bf16 first position {first}",
                "max_ulps": ulps, "max_abs_err": gap, "equal_share": equal,
                "ms": time_ms(kernel, sets, 50),
                "eager_ms": time_ms(kernel, sets, 50, graph=False),
                "plain_ms": time_ms(plain, sets, 20),
                "plain_eager_ms": time_ms(plain, sets, 20, graph=False),
                "library_ms": None,
                "bound_ms": per_set / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "reported": not rope_lines}
        print(json.dumps(line), flush=True)
        rope_lines.append(line)
        del sets
    torch.cuda.empty_cache()
    return norm_lines, rope_lines


def parity_run(cfg, seed: int, kernels: dict, batch: int = 2) -> dict:
    """(a) of phases 8, 11, 13 and 14: ``cfg`` (float32, the kernels' path)
    with weights from ``seed``, B ``batch``, a 512-token prompt: forward
    logits against the plain-torch path (``attn_impl="xla"``) within 1e-4
    (only the kernels' sums differ), and 16 greedy tokens against teacher
    forcing. The summary carries the launches of each of ``kernels`` (name
    -> wrapper) in the forward and in the generation."""
    import dataclasses

    from repro_torch.models import sampling, transformer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = transformer.init_params(gen, cfg)
    prompt = torch.randint(0, cfg.vocab_size, (batch, 512), generator=gen,
                           device=dev, dtype=torch.int32)
    tol = 1e-4
    with torch.no_grad():
        for k in kernels.values():
            k.launches = 0
        got, _ = transformer.forward(params, prompt, cfg)
        fwd = {n: k.launches for n, k in kernels.items()}
        want, _ = transformer.forward(
            params, prompt, dataclasses.replace(cfg, attn_impl="xla"))
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=tol, atol=tol):
            raise AssertionError(f"forward logits, kernels vs plain path: "
                                 f"max |err| {err} > tol {tol}")
        for k in kernels.values():
            k.launches = 0
        out = sampling.generate(params, prompt, cfg, max_new_tokens=16)
        generate = {n: k.launches for n, k in kernels.items()}
        ties = greedy_vs_teacher_forcing(transformer, params, prompt, out,
                                         cfg)
    del params, got, want
    torch.cuda.empty_cache()
    return {"forward_max_abs_err": err, "tol": tol,
            "generated": list(out.shape), "ties": ties,
            "launches_forward": fwd, "launches_generate": generate}


def greedy_vs_teacher_forcing(transformer, params, prompt, out, cfg):
    """Each generated token against the argmax of a full forward over the
    prompt and the tokens before it; a row may differ only on a float32
    near-tie (top two logits within 1e-4). Returns the number of ties."""
    seq, ties = prompt, 0
    for i in range(out.shape[1]):
        logits, _ = transformer.forward(params, seq, cfg)
        last = logits[:, -1]
        nxt = torch.argmax(last, -1).to(torch.int32)
        for row in torch.nonzero(out[:, i] != nxt).flatten().tolist():
            top2 = torch.topk(last[row], 2).values
            if (top2[0] - top2[1]).item() > 1e-4:
                raise AssertionError(
                    f"greedy token {i} of row {row}: generate gave "
                    f"{int(out[row, i])}, teacher forcing {int(nxt[row])}")
            ties += 1
        seq = torch.cat([seq, out[:, i:i + 1]], dim=1)
    return ties


def family_split(fn, names, n_other: int = 4):
    """Device ms of one call of ``fn`` by kernel family, and the
    ``n_other`` largest kernels of the family "other", by name. Every
    kernel is first put in its family by name: the first of ``names`` it
    holds (the port's own kernels, launched through ctypes, have no torch
    op above them), the matmuls (cuBLAS/CUTLASS), or "other". A kernel
    that a torch op launched inside ``moe_block``'s "moe_experts" span (its
    two expert products and the SiLU between them) then moves to the family
    "moe_experts", and one launched elsewhere inside its "moe_block" span
    (routing, slots, dispatch and combine gathers) to
    "moe_route_dispatch_combine" (``torch.profiler`` with CPU and CUDA
    activity); a model without MoE layers has no such span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = ("moe_experts", "moe_block")
    out = {n: 0.0 for n in (*names, "moe_experts",
                            "moe_route_dispatch_combine", "matmul", "other")}
    other = {}

    def family(name):
        key = name.lower()
        return next((n for n in names if n in key), None) or (
            "matmul" if any(m in key for m in (
                "gemm", "gemv", "xmma", "cutlass", "cublas", "nvjet",
                "matmul")) else "other")

    def add(fam, name, ms):
        out[fam] += ms
        if fam == "other":
            other[name[:60]] = other.get(name[:60], 0.0) + ms

    events = prof.events()
    for e in events:            # every kernel, by name
        if e.device_type == DeviceType.CUDA and e.name not in spans \
                and not getattr(e, "is_user_annotation", False):
            add(family(e.name), e.name, e.device_time_total / 1e3)
    for e in events:            # those launched inside a span move to it
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        enclosing, parent = set(), e
        while parent is not None:
            enclosing.add(parent.name)
            parent = parent.cpu_parent
        span = ("moe_experts" if "moe_experts" in enclosing else
                "moe_route_dispatch_combine" if "moe_block" in enclosing
                else None)
        for k in e.kernels:
            if span and k.name not in spans:
                add(family(k.name), k.name, -k.duration / 1e3)
                out[span] += k.duration / 1e3
    top = dict(sorted(other.items(), key=lambda kv: -kv[1])[:n_other])
    return out, top


def whole_model_run(cfg, seeds, kernels: dict, prefill_names,
                    decode_names) -> dict:
    """(b) of phases 8, 11, 13 and 14: ``cfg`` whole or cut (bf16 weights
    from ``seeds[0]``), B 1, a 4096-token prompt from ``seeds[1]``: the
    prefill and 32 decode steps timed by CUDA events, the launches of each
    of ``kernels`` in each, and the device time of a prefill and of a
    decode step by kernel family (``family_split``)."""
    from repro_torch.convert import flatten_params
    from repro_torch.models import transformer

    dev = torch.device("cuda")
    params = transformer.init_params(
        torch.Generator(device=dev).manual_seed(seeds[0]), cfg)
    flat = flatten_params(params)
    nbytes = sum(t.numel() * t.element_size() for t in flat.values())
    n_params = sum(t.numel() for t in flat.values())
    del flat
    prompt = torch.randint(0, cfg.vocab_size, (1, 4096), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               seeds[1]), dtype=torch.int32)
    width, steps = 4096 + 32, 32
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def decode_loop(logits, cache, n):
        tok = torch.argmax(logits, -1).to(torch.int32)
        for i in range(n):
            logits, cache = transformer.decode_step(params, tok[:, None],
                                                    4096 + i, cache, cfg)
            tok = torch.argmax(logits, -1).to(torch.int32)
        return logits

    with torch.no_grad():
        transformer.prefill(params, prompt, cfg, width)        # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        start.record()
        logits, cache = transformer.prefill(params, prompt, cfg, width)
        end.record()
        end.synchronize()
        prefill_ms = start.elapsed_time(end)
        at_prefill = {n: k.launches for n, k in kernels.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        start.record()
        last = decode_loop(logits, cache, steps)
        end.record()
        end.synchronize()
        token_ms = start.elapsed_time(end) / steps
        in_decode = {n: k.launches - at_prefill[n]
                     for n, k in kernels.items()}
        if not torch.isfinite(last.float()).all():
            raise AssertionError("non-finite logits after 32 decode steps")
        pre_split, pre_other = family_split(
            lambda: transformer.prefill(params, prompt, cfg, width),
            prefill_names)
        logits, cache = transformer.prefill(params, prompt, cfg, width)
        dec_split, dec_other = family_split(
            lambda: decode_loop(logits, cache, 8), decode_names)
    del params, cache, logits
    torch.cuda.empty_cache()
    per_step = lambda split: {k: v / 8 for k, v in split.items()}
    return {"params": n_params, "weights_gb": nbytes / 1e9, "prompt": 4096,
            "prefill_ms": prefill_ms, "prefill_peak_gb": peak_gb,
            "decode_ms_per_token": token_ms,
            "launches_prefill": at_prefill,
            "launches_32_decode_steps": in_decode,
            "prefill_device_ms_by_kernel": pre_split,
            "prefill_other_top_ms": pre_other,
            "decode_step_device_ms_by_kernel": per_step(dec_split),
            "decode_other_top_ms": per_step(dec_other)}


def transformer_phases(fa, da, an, rp):
    """Phase 8 at StarCoder2-3B's full width; returns (a)'s and (b)'s
    summaries."""
    import dataclasses

    from repro_torch.configs import get_config

    base = dataclasses.replace(get_config("starcoder2_3b"), remat=False,
                               attn_impl="pallas")
    kernels = {"flash_attention": fa.flash_attention,
               "decode_attention": da.decode_attention,
               "add_norm": an.add_norm, "rope": rp.rope}
    # (a) parity: 2 layers, float32 weights and compute
    cfg = dataclasses.replace(base, num_layers=2, compute_dtype="float32")
    summary_a = {"phase": "8a parity, 2 layers fp32",
                 **parity_run(cfg, 3, kernels)}
    print(json.dumps(summary_a), flush=True)
    n = cfg.num_layers
    check_launches(summary_a, {"flash_attention": n, "decode_attention": 0,
                               **norms_ropes(2 * n + 1, n)},
                   "launches_forward")
    check_launches(summary_a, {"flash_attention": n,
                               "decode_attention": n * 15,
                               **norms_ropes(2 * n + 1, n, 16)},
                   "launches_generate")

    # (b) the whole model: 30 layers, bf16 weights and compute
    cfg = dataclasses.replace(base, param_dtype="bfloat16")
    routes = dict(fa.flash_attention.routes)
    summary_b = {"phase": "8b starcoder2-3b, 30 layers bf16",
                 **whole_model_run(cfg, (4, 5), kernels,
                                   ("flash_wgmma_kernel",
                                    "flash_bf16_kernel"),
                                   ("decode_attention_kernel",))}
    pre, dec = (summary_b["prefill_device_ms_by_kernel"],
                summary_b["decode_step_device_ms_by_kernel"])
    summary_b["prefill_flash_share"] = (
        pre["flash_wgmma_kernel"] + pre["flash_bf16_kernel"]) / max(
        sum(pre.values()), 1e-9)
    summary_b["decode_attention_share"] = dec["decode_attention_kernel"] / max(
        sum(dec.values()), 1e-9)
    summary_b["flash_routes"] = {k: v - routes[k] for k, v in
                                 fa.flash_attention.routes.items()}
    print(json.dumps(summary_b), flush=True)
    n = cfg.num_layers
    check_launches(summary_b, {"flash_attention": n, "decode_attention": 0,
                               **norms_ropes(2 * n + 1, n)},
                   "launches_prefill")
    check_launches(summary_b, {"flash_attention": 0,
                               "decode_attention": n * 32,
                               **norms_ropes(2 * n + 1, n, 32)},
                   "launches_32_decode_steps")
    if summary_b["flash_routes"]["wgmma"] == 0 or \
            summary_b["flash_routes"]["mma"] != 0:
        raise AssertionError("the 4096-token prefills took "
                             f"{summary_b['flash_routes']}: all should take "
                             "the wgmma kernel")
    return summary_a, summary_b


# the norm and RoPE launches of one forward of an expert of n layers, by
# arch: a norm before each mixer and each feed-forward and a final one, a
# RoPE each attention layer
NORMS_ROPES_PER_FORWARD = {"starcoder2_3b": lambda n: (2 * n + 1, n),
                           "falcon_mamba_7b": lambda n: (n + 1, 0),
                           "moonshot_v1_16b_a3b": lambda n: (2 * n + 1, n)}


def norms_ropes(norms: int, ropes: int, forwards: int = 1) -> dict:
    """The launches of the norm and RoPE kernels in ``forwards`` forwards
    of ``norms`` norms and ``ropes`` RoPEs each."""
    return {"add_norm": norms * forwards, "rope": ropes * forwards}


def lm_router_phase(kernel, arch: str = "starcoder2_3b", layers: int = 2):
    """Phases 9, 12 and 15: the LM router with ``arch``'s experts at full
    width, depth cut to ``layers``; every prompt completes, the launches of
    ``kernel`` (the wrapper of the one kernel each layer runs once a
    forward: flash attention, or the selective scan) = layers x expert
    forwards, those of the norm and RoPE kernels
    ``NORMS_ROPES_PER_FORWARD`` x expert forwards, and every served
    forward's tokens equal the plain-torch path (``attn_impl="xla"``) on
    the same padded batch. Returns the lines and each kernel's launches
    under both policies, by name."""
    from repro_torch.core import COSERVE, SAMBA_PARALLEL, run_real
    from repro_torch.kernels import add_norm as an
    from repro_torch.kernels import rope as rp
    from repro_torch.launch import lm_coe_router as router

    cfg = router.lm_config("full", layers, arch)
    kernels = {kernel.__name__: kernel, "add_norm": an.add_norm,
               "rope": rp.rope}
    per_forward = NORMS_ROPES_PER_FORWARD[arch](cfg.num_layers)
    rng = np.random.RandomState(0)
    store, lines = None, []
    launches = dict.fromkeys(kernels, 0)
    served = []        # (expert id, padded tokens, served argmax), on the host
    try:
        for policy in (COSERVE, SAMBA_PARALLEL):
            t0 = time.perf_counter()
            system, _ = router.build_lm_system(cfg, policy, device="cuda",
                                               store=store)
            store = system.engine.store
            built_s = time.perf_counter() - t0
            engine = system.engine
            lm_apply = engine.apply_fns["tiny_lm"]
            execute, current = engine.execute, {}

            def record_execute(ex, eid, batch, execute=execute,
                               current=current):
                current["eid"] = eid
                return execute(ex, eid, batch)

            def record_apply(params, tokens, lm_apply=lm_apply,
                             current=current):
                out = lm_apply(params, tokens)
                served.append((current["eid"], tokens.cpu(), out.cpu()))
                return out

            engine.execute = record_execute
            engine.apply_fns["tiny_lm"] = record_apply
            reqs = router.make_requests(rng, cfg)
            lm_apply.calls = 0
            for k in kernels.values():
                k.launches = 0
            routes = dict(getattr(kernel, "routes", {}))
            m = run_real(system, reqs)
            counts = {n: k.launches for n, k in kernels.items()}
            count = counts[kernel.__name__]
            calls = lm_apply.calls
            for n in launches:
                launches[n] += counts[n]
            line = {"arch": arch, "policy": policy.name,
                    "completed": m.completed, "requests": len(reqs),
                    "expert_loads": m.switches, "makespan_s": m.makespan,
                    "forwards": calls, "kernel": kernel.__name__,
                    "kernel_launches": count,
                    "norm_launches": counts["add_norm"],
                    "rope_launches": counts["rope"], "build_s": built_s,
                    "layers": cfg.num_layers, "d_model": cfg.d_model,
                    "param_dtype": cfg.param_dtype}
            if routes:          # the flash kernel: which kernel each took
                line["routes"] = {k: v - routes[k]
                                  for k, v in kernel.routes.items()}
            print(json.dumps(line), flush=True)
            lines.append(line)
            if m.completed != len(reqs):
                raise AssertionError(f"{m.completed} of {len(reqs)} prompts")
            if not 0 < count == cfg.num_layers * calls:
                raise AssertionError(f"{count} {kernel.__name__} launches for "
                                     f"{calls} forwards of {cfg.num_layers} "
                                     "layers")
            want = norms_ropes(*per_forward, calls)
            if {n: counts[n] for n in want} != want:
                raise AssertionError(f"{arch} {policy.name}: norm and RoPE "
                                     f"launches {counts} for {calls} "
                                     f"forwards, the path gives {want}")
            del system, engine, record_execute, record_apply
            gc.collect()       # the engine's device copies of the experts
            torch.cuda.empty_cache()
        lines.append(check_served(store, served, cfg))
    finally:
        if store is not None:
            shutil.rmtree(store.root, ignore_errors=True)
    return lines, launches


@contextlib.contextmanager
def wrapped(module, name: str, wrapper):
    """Within the block, ``module.<name>`` is ``wrapper(original)``."""
    original = getattr(module, name)
    setattr(module, name, wrapper(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def moe_drops(records: list):
    """Within the block, every ``moe_block`` call of a single group (at most
    ``GROUP_SIZE`` tokens) also appends to ``records`` its capacity, each
    expert's load ([E], as the call returned it) and each token's choices
    past the capacity ([t]), from its router's choices and slots counted
    as the reference counts them (a cumsum of one-hots), whose loads must
    equal the call's."""
    import torch.nn.functional as F

    from repro_torch.models import moe

    def recording(block):
        def call(p, h, c, cdtype=torch.bfloat16):
            b, s, d = h.shape
            t = b * s
            if t > moe.GROUP_SIZE:
                raise ValueError(f"{t} tokens: more than one MoE group")
            out, aux, load = block(p, h, c, cdtype)
            _, _, top_i = moe.route(p, h.reshape(1, t, d), c, cdtype)
            flat = top_i[0].reshape(-1)
            oh = F.one_hot(flat, c.moe_num_experts)
            if not torch.equal(oh.sum(0).to(load.dtype), load):
                raise AssertionError("moe_block's expert_load differs from "
                                     "its router's one-hot counts")
            slot = (oh.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
            cap = moe.expert_capacity(t, c)
            records.append({"cap": cap, "load": load,
                            "dropped": (slot >= cap).reshape(t, -1).sum(-1)})
            return out, aux, load
        return call

    return wrapped(moe, "moe_block", recording)


def pinned_routing(own: list, pinned=None):
    """Within the block, every ``moe.route`` call appends its own router's
    probabilities and chosen experts to ``own``; with ``pinned`` (the
    ``own`` list of an earlier run of the same forward), it then routes
    each token to the experts that run chose at the same call, their
    weights from this call's own probabilities, renormalised. Two paths
    run with one set of choices compute the same function, so their
    logits can be compared on every row."""
    from repro_torch.models import moe

    def pinning(route):
        def call(params, xg, cfg, cdtype):
            probs, top_w, top_i = route(params, xg, cfg, cdtype)
            own.append({"probs": probs, "experts": top_i})
            if pinned is not None:
                top_i = pinned[len(own) - 1]["experts"]
                top_w = probs.gather(-1, top_i)
                top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True),
                                            min=1e-9)
            return probs, top_w, top_i
        return call

    return wrapped(moe, "route", pinning)


def router_near_ties(pinned, own, seq: int) -> set:
    """The rows whose tokens' own routers chose other experts than the
    pinned run's at some MoE call. Every such token must sit at a near-tie:
    the gap between its k-th and (k+1)-th probabilities at most twice the
    two runs' difference in them."""
    rows = set()
    for p, o in zip(pinned, own):
        k = p["experts"].shape[-1]
        probs_p = p["probs"].reshape(-1, p["probs"].shape[-1])
        probs_o = o["probs"].reshape(probs_p.shape)
        flips = (p["experts"].sort(-1).values
                 != o["experts"].sort(-1).values).any(-1).reshape(-1)
        for tok in torch.nonzero(flips).flatten().tolist():
            top = torch.sort(probs_o[tok], descending=True).values
            gap = (top[k - 1] - top[k]).item()
            dprob = (probs_p[tok] - probs_o[tok]).abs().max().item()
            if gap > 2 * dprob:
                chose = [r["experts"].reshape(-1, k)[tok].tolist()
                         for r in (p, o)]
                raise AssertionError(
                    f"token {tok}: routed to {chose[0]} and {chose[1]} with "
                    f"a gap of {gap} between its k-th and next "
                    f"probabilities (the runs differ by {dprob})")
            rows.add(tok // seq)
    return rows


# check_served with MoE experts: rows beyond the bf16 tolerance are held
# against a float32 forward, by the RMS over the vocabulary of each path's
# distance to it, kernel path over plain path: at most ROW_RATIO on each
# such row and POOLED_RATIO pooled over all rows, while the kernel path
# with its flash outputs scaled by 1 + each of CONTROL_ERRORS is also run,
# and the last of them must fail the pooled bound. The bounds are set from
# this check's readings on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
# the sound rows' largest ratio 1.52, pooled 0.996; a flash output off by
# 2^-5 pooled 1.12, by one bf16 ulp (2^-7) 1.03.
ROW_RATIO = 2.0
POOLED_RATIO = 1.05
CONTROL_ERRORS = (2.0 ** -7, 2.0 ** -5)


def scaled_flash(err: float):
    """A wrapper of ``flash_attention_op`` whose outputs are off by a
    factor 1 + ``err``: the fault that check_served's control runs."""
    def wrap(op):
        def call(*args, **kwargs):
            out = op(*args, **kwargs)
            return (out.float() * (1 + err)).to(out.dtype)
        return call
    return wrap


def check_served(store, served, cfg):
    """Every forward phase 9, 12 or 15 served, run again on the same padded
    batch through the kernel path and the plain-torch path: the last
    position's logits of the two agree within the bf16 tolerance, the
    served tokens are the kernel path's argmax, and they equal the plain
    path's argmax but on rows whose top two logits lie within the two
    paths' difference (a near-tie either path may break).

    With MoE layers, the plain path (and a float32-compute plain run) route
    every token to the experts the kernel path chose (``pinned_routing``),
    so that every row stays comparable; where its own router chose other
    experts, the token must sit at a router near-tie (``router_near_ties``),
    and such rows are counted. These random weights amplify bf16 roundings
    (``w_in`` is drawn at 1/sqrt(experts), so an expert's output reaches ~30
    a component): two correct bf16 paths routed alike differ by more than
    the tolerance on some rows, each about as far from the float32 logits
    as the other. Such rows are counted, and held to the float32 logits
    (``ROW_RATIO``, ``POOLED_RATIO``); control runs with a flash output
    off by each of ``CONTROL_ERRORS`` show what the pooled bound can tell
    apart, and the check fails if the largest of them passes it."""
    import dataclasses

    from repro_torch.convert import nest_params
    from repro_torch.models import layers, transformer

    tol = 5e-2          # bf16 compute: a few roundings of 2^-8 on logits ~1
    plain_cfg = dataclasses.replace(cfg, attn_impl="xla")
    exact_cfg = dataclasses.replace(plain_cfg, compute_dtype="float32")
    has_moe = any(s.ffn == "moe" for s in cfg.block_pattern())
    worst, rows, ties, tie_rows, beyond = 0.0, 0, 0, 0, 0
    row_ratio = 0.0
    # sums over rows of the mean square distance to the float32 logits:
    # the kernel path, the plain path, each control
    sq = {"kernel": 0.0, "plain": 0.0, **{e: 0.0 for e in CONTROL_ERRORS}}

    def fwd(params, x, c):
        return transformer.forward(params, x, c, mode="eval")[0][
            :, -1].float()

    for eid in sorted({e for e, _, _ in served}):
        params = nest_params({k: v.to("cuda") for k, v in
                              store.fetch(eid)[0].items()})
        for e, tokens, out in served:
            if e != eid:
                continue
            x = tokens.cuda()
            kern_rec, plain_rec, exact_rec = [], [], []
            with torch.no_grad(), pinned_routing(kern_rec):
                kern = fwd(params, x, cfg)
            with torch.no_grad(), pinned_routing(plain_rec, kern_rec):
                plain = fwd(params, x, plain_cfg)
            diff = (kern - plain).abs()
            worst = max(worst, diff.max().item())
            within = torch.isclose(kern, plain, rtol=tol, atol=tol).all(-1)
            if has_moe:
                with torch.no_grad(), pinned_routing(exact_rec, kern_rec):
                    exact = fwd(params, x, exact_cfg)
                tie_rows += len(router_near_ties(kern_rec, plain_rec,
                                                 x.shape[1])
                                | router_near_ties(kern_rec, exact_rec,
                                                   x.shape[1]))
                ms = lambda y: (y - exact).pow(2).mean(-1)     # [rows]
                ek, ep = ms(kern), ms(plain)
                sq["kernel"] += ek.sum().item()
                sq["plain"] += ep.sum().item()
                for err in CONTROL_ERRORS:
                    with torch.no_grad(), pinned_routing([], kern_rec), \
                            wrapped(layers, "flash_attention_op",
                                    scaled_flash(err)):
                        sq[err] += ms(fwd(params, x, cfg)).sum().item()
                for row in torch.nonzero(~within).flatten().tolist():
                    ratio = (ek[row] / ep[row]).sqrt().item()
                    row_ratio = max(row_ratio, ratio)
                    if ratio > ROW_RATIO:
                        raise AssertionError(
                            f"{eid} row {row}: the kernel path's logits lie "
                            f"{ratio} times as far from the float32 logits "
                            f"as the plain path's (bound {ROW_RATIO})")
                    within[row] = True
                    beyond += 1
            if not within.all():
                raise AssertionError(
                    f"{eid}: last-position logits, kernel vs plain path, "
                    f"max |err| {diff.max().item()} > tol {tol}")
            served_tok = out.to("cuda", torch.long)
            if not torch.equal(served_tok, torch.argmax(kern, -1)):
                raise AssertionError(f"{eid}: served tokens "
                                     f"{out.tolist()} are not the kernel "
                                     "path's argmax on the same batch")
            want = torch.argmax(plain, -1)
            top2 = torch.topk(plain, 2, dim=-1).values
            gap = top2[:, 0] - top2[:, 1]
            for row in torch.nonzero(served_tok != want).flatten().tolist():
                if gap[row].item() > 2 * diff[row].max().item():
                    raise AssertionError(
                        f"{eid} row {row}: served token "
                        f"{int(served_tok[row])}, plain path "
                        f"{int(want[row])} (top-2 gap {gap[row].item()})")
                ties += 1
            rows += x.shape[0]
        del params
        torch.cuda.empty_cache()
    line = {"check": "served vs plain path", "forwards": len(served),
            "rows": rows, "near_ties": ties, "logits_max_abs_err": worst,
            "tol": tol}
    if has_moe:
        pooled = {k: math.sqrt(v / sq["plain"]) for k, v in sq.items()
                  if k != "plain"}
        line.update({
            "router_near_tie_rows": tie_rows,
            "rows_beyond_tol_held_to_float32": beyond,
            "row_rms_to_float32_kernel_over_plain_max": row_ratio,
            "row_bound": ROW_RATIO,
            "pooled_rms_to_float32_kernel_over_plain": pooled["kernel"],
            "pooled_bound": POOLED_RATIO,
            "controls_pooled": {f"flash x (1 + {e})": pooled[e]
                                for e in CONTROL_ERRORS}})
    print(json.dumps(line), flush=True)
    if has_moe:
        if pooled["kernel"] > POOLED_RATIO:
            raise AssertionError(
                f"the kernel path's logits lie {pooled['kernel']} times as "
                f"far from the float32 logits as the plain path's, pooled "
                f"over {rows} rows (bound {POOLED_RATIO})")
        if pooled[CONTROL_ERRORS[-1]] <= POOLED_RATIO:
            raise AssertionError(
                f"a flash output off by {CONTROL_ERRORS[-1]} passes the "
                f"pooled bound ({pooled[CONTROL_ERRORS[-1]]}): the check "
                "cannot tell it from rounding")
    return line


# (label, batch, S, D, N, x dtype, dt dtype, B/C dtype, tolerance)
MAMBA_GEOMETRIES = [
    ("falcon-mamba prefill", 1, 4096, 8192, 16, BF16, F32, F32, 2e-2),
    ("fp32 over 4096 steps", 1, 4096, 2048, 16, F32, F32, F32, 1e-5),
    ("ragged fp32", 2, 1000, 1000, 16, F32, F32, F32, 1e-5),
    ("all bf16, state 8", 2, 333, 520, 8, BF16, BF16, BF16, 2e-2),
    # phase 12's forwards: 16-token prompts in batches padded to 1/2/4/8
    *((f"lm router, batch {b}", b, 16, 8192, 16, BF16, F32, F32, 2e-2)
      for b in (1, 2, 4, 8)),
    # sequence lengths on each side of the scan's crossover (SCAN_MIN_SEQ),
    # at Falcon-Mamba's width
    *((f"crossover S {s}", 1, s, 8192, 16, BF16, F32, F32, 2e-2)
      for s in (64, SCAN_MIN_SEQ - 1, SCAN_MIN_SEQ, 512, 1024, 2048)),
]
MAMBA_REPORTED = "falcon-mamba prefill"


# the geometries whose kernels a call phase 10 counts, one of each route
MAMBA_PROFILED = ("falcon-mamba prefill", "lm router, batch 1")
PROFILE_SCAN = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import mamba_scan as ms
b, s, d, n = map(int, sys.argv[2:6])
xt, dtt, bct = (getattr(torch, t) for t in sys.argv[6:9])
g = torch.Generator(device="cuda").manual_seed(0)
r = lambda *shape: torch.randn(shape, generator=g, device="cuda")
args = (r(b, s, d).to(xt), torch.nn.functional.softplus(r(b, s, d)).to(dtt),
        r(b, s, n).to(bct), r(b, s, n).to(bct), -torch.exp(r(d, n)), r(d))
ms.mamba_scan(*args)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(5):
        ms.mamba_scan(*args)
    torch.cuda.synchronize()
print(json.dumps({e.key[:60]: e.count / 5 for e in prof.key_averages()
                  if e.device_time_total > 0}))
"""


def scan_kernels_per_call(b, s, d, n, xt, dtt, bct) -> dict:
    """The CUDA kernels one ``mamba_scan`` call launches, by name, from
    ``torch.profiler``'s CUDA activity over five calls in a fresh process
    (after this process's many profiles the tracer has missed launches of
    a repeated kernel)."""
    out = subprocess.run(
        [sys.executable, "-c", PROFILE_SCAN, os.path.join(ROOT, "src"),
         *map(str, (b, s, d, n)), *(str(t).split(".")[1]
                                     for t in (xt, dtt, bct))],
        check=True, capture_output=True, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def mamba_vs_plain(ms, ref):
    """Phase 10: one line per geometry; returns the lines. Inputs: dt a
    softplus, A negative. The tolerance holds y and the final state: in
    bf16, 2e-2 relative and absolute (y is rounded to bf16); in float32,
    1e-5 relative and 1e-5 of the largest |value| absolute, since y_t sums
    N products C h whose size is the state's (hundreds here) and which
    cancel, and the kernel sums them in another order. Every geometry both
    kernels take is run through each, held against the plain version, and
    the two are timed in turns (seq, chunked, chunked, seq); the line
    names the route ``plan`` picks, and for ``MAMBA_PROFILED`` the
    profiler's kernels a call."""
    lines = []
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    for label, b, s, d, n, xt, dtt, bct, tol in MAMBA_GEOMETRIES:
        size = lambda t: 2 if t == BF16 else 4
        per_set = b * s * d * (2 * size(xt) + size(dtt)) \
            + 2 * b * s * n * size(bct)
        copies = max(1, min(8, math.ceil(2 * L2_BYTES / per_set)))

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        a = -torch.exp(randn(d, n))
        d_vec = randn(d)
        sets = [(randn(b, s, d).to(xt),
                 torch.nn.functional.softplus(randn(b, s, d)).to(dtt),
                 randn(b, s, n).to(bct), randn(b, s, n).to(bct), a, d_vec)
                for _ in range(copies)]
        want_y, want_h = ref.mamba_scan_ref(*sets[0])

        def check(out, who):
            err, scale = 0.0, 0.0
            for got, want in ((out[0].float(), want_y.float()),
                              (out[1], want_h)):
                top = want.abs().max().item()
                atol = tol * top if xt == F32 else tol
                err = max(err, (got - want).abs().max().item())
                scale = max(scale, top)
                if not torch.allclose(got, want, rtol=tol, atol=atol):
                    raise AssertionError(
                        f"mamba_scan ({who}) disagrees with its plain version "
                        f"at {label}: max |err| {err} > tol {tol} (atol "
                        f"{atol})")
            return err, scale

        route = ms.plan(b, s, d, n, ms.rows_aligned(*sets[0][:2]))["route"]
        before = dict(ms.mamba_scan.routes)
        err, scale = check(ms.mamba_scan(*sets[0]), "wrapper")
        torch.cuda.synchronize()
        if ms.mamba_scan.routes[route] != before[route] + 1:
            raise AssertionError(f"{label}: the call did not take the "
                                 f"{route} kernel")
        ms_kernel = time_ms(ms.mamba_scan, sets, 20)
        eager_ms = time_ms(ms.mamba_scan, sets, 20, graph=False)
        plain_ms = time_ms(ref.mamba_scan_ref, sets[:1],
                           1 if s > 1000 else 3)
        per_call = None
        if label in MAMBA_PROFILED:
            per_call = scan_kernels_per_call(b, s, d, n, xt, dtt, bct)
            name = {"seq": "mamba_scan_kernel",
                    "chunked": "mamba_scan_chunked_kernel"}[route]
            if list(per_call.values()) != [1] or \
                    name not in next(iter(per_call)):
                raise AssertionError(f"{label}: the profiler saw {per_call} "
                                     f"a call, not one {name}")
        # both kernels where both take the shape: each against the plain
        # version, then in turns
        routes_ms, routes_err = {}, {}
        if d % 8 == 0 and ms.rows_aligned(*sets[0][:2]):
            for name in ms.ROUTES:
                routes_err[name] = check(
                    ms.launch(*sets[0], kernel=name), name)[0]
            for name in ("seq", "chunked", "chunked", "seq"):
                routes_ms.setdefault(name, []).append(time_ms(
                    lambda *args, name=name: ms.launch(*args, kernel=name),
                    sets, 20))
        # bound: x, dt, B, C, A, D read once, y and h written once; per
        # (b, s, d, n) the exponential, dt*A, dtx*B, the state's FMA and the
        # C FMA (7 operations), per (b, s, d) dt*x and the D skip (3)
        nbytes = (b * s * d * (2 * size(xt) + size(dtt))
                  + 2 * b * s * n * size(bct) + d * n * 4 + d * 4
                  + b * d * n * 4)
        ops = b * s * d * (7 * n + 3)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
        line = {"shape": f"{label}: B={b} S={s} D={d} N={n} x "
                         f"{'bf16' if xt == BF16 else 'fp32'} dt "
                         f"{'bf16' if dtt == BF16 else 'fp32'} B/C "
                         f"{'bf16' if bct == BF16 else 'fp32'}",
                "route": route, "max_abs_err": err, "max_abs_value": scale,
                "tol": tol, "ms": ms_kernel,
                "eager_ms": eager_ms, "plain_ms": plain_ms,
                "library_ms": None,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes_ms": t_bytes * 1e3, "ops_ms": t_ops * 1e3,
                "sfu_exp_ms": b * s * d * n / SFU_EXP_PER_S * 1e3,
                "kernels_per_call": per_call,
                "routes_in_turns_ms": routes_ms,
                "routes_max_abs_err": routes_err,
                "reported": label == MAMBA_REPORTED}
        if label == MAMBA_REPORTED:
            line["chunked_blocks_per_sm"] = ms.occupancy(n, xt, dtt, bct)
        print(json.dumps(line), flush=True)
        lines.append(line)
        del sets, want_y, want_h
        torch.cuda.empty_cache()
    return lines


def falcon_phases(ms, an, rp):
    """Phase 11 at Falcon-Mamba-7B's published width; returns (a)'s and
    (b)'s summaries. Every prefill and full-sequence forward launches the
    scan kernel once a layer; decode steps run the recurrence in torch."""
    import dataclasses

    from repro_torch.configs import get_config

    base = dataclasses.replace(get_config("falcon_mamba_7b"), remat=False,
                               attn_impl="pallas")
    kernels = {"mamba_scan": ms.mamba_scan, "add_norm": an.add_norm,
               "rope": rp.rope}
    scan = ms.mamba_scan

    def routes_since(before):
        return {k: v - before[k] for k, v in scan.routes.items()}

    # (a) parity: 2 layers, float32 weights and compute; B 2 and a
    # 512-token prompt, so every scan takes the route plan gives that shape
    cfg = dataclasses.replace(base, num_layers=2, compute_dtype="float32")
    before = dict(scan.routes)
    summary_a = {"phase": "11a parity, 2 layers fp32",
                 **parity_run(cfg, 6, kernels)}
    summary_a["scan_routes"] = routes_since(before)
    print(json.dumps(summary_a), flush=True)
    n = cfg.num_layers
    check_launches(summary_a, {"mamba_scan": n, **norms_ropes(n + 1, 0)},
                   "launches_forward")
    check_launches(summary_a, {"mamba_scan": n, **norms_ropes(n + 1, 0, 16)},
                   "launches_generate")
    want = ms.plan(2, 512, cfg.ssm_expand * cfg.d_model,
                   cfg.ssm_state_dim)["route"]
    if summary_a["scan_routes"][want] != sum(
            summary_a["scan_routes"].values()):
        raise AssertionError(f"11a: scans took {summary_a['scan_routes']}, "
                             f"all should take {want}")

    # (b) the whole model: 64 layers, bf16 weights and compute
    cfg = dataclasses.replace(base, param_dtype="bfloat16")
    before = dict(scan.routes)
    summary_b = {"phase": "11b falcon-mamba-7b, 64 layers bf16",
                 **whole_model_run(cfg, (7, 8), kernels,
                                   ("mamba_scan",), ())}
    summary_b["scan_routes"] = routes_since(before)
    pre = summary_b["prefill_device_ms_by_kernel"]
    summary_b["prefill_scan_share"] = pre["mamba_scan"] / max(
        sum(pre.values()), 1e-9)
    print(json.dumps(summary_b), flush=True)
    n = cfg.num_layers
    check_launches(summary_b, {"mamba_scan": n, **norms_ropes(n + 1, 0)},
                   "launches_prefill")
    check_launches(summary_b, {"mamba_scan": 0, **norms_ropes(n + 1, 0, 32)},
                   "launches_32_decode_steps")
    if summary_b["scan_routes"]["seq"] != 0 or \
            summary_b["scan_routes"]["chunked"] % n:
        raise AssertionError(f"11b: the 4096-token prefills' scans took "
                             f"{summary_b['scan_routes']}: all should take "
                             "the chunked kernel, 64 a prefill")
    return summary_a, summary_b


def check_launches(summary, want: dict, key: str) -> None:
    if summary[key] != want:
        raise AssertionError(f"{summary['phase']}: {key} {summary[key]}, "
                             f"the path gives {want}")


def moe_weight_floor(cfg) -> dict:
    """The expert weights one decode step reads, at most (every expert, as
    the dense-capacity dispatch runs them) and at least (the chosen top-k
    experts), and their times at the card's memory rate."""
    ff = cfg.moe_d_ff or cfg.d_ff
    n_moe = cfg.num_periods() * sum(s.ffn == "moe"
                                    for s in cfg.block_pattern())
    size = 2 if cfg.param_dtype == "bfloat16" else 4
    per_expert = 3 * cfg.d_model * ff * size * n_moe
    every = cfg.moe_num_experts * per_expert
    chosen = cfg.moe_top_k * per_expert
    return {"all_experts_gb": every / 1e9,
            "all_experts_ms": every / HBM_BYTES_PER_S * 1e3,
            "chosen_experts_gb": chosen / 1e9,
            "chosen_experts_ms": chosen / HBM_BYTES_PER_S * 1e3}


def moonlight_phases(fa, da, an, rp):
    """Phase 13 at Moonlight-16B-A3B's published width; returns (a)'s and
    (b)'s summaries."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    base = dataclasses.replace(get_config("moonshot_v1_16b_a3b"),
                               remat=False, attn_impl="pallas")
    kernels = {"flash_attention": fa.flash_attention,
               "decode_attention": da.decode_attention,
               "add_norm": an.add_norm, "rope": rp.rope}
    # (a) parity: 2 layers in float32. Generation runs dropless decode
    # steps while teacher forcing routes prompt and new tokens in one group,
    # so both are held at a capacity factor of E / k, where every expert
    # can take every token (dropless); at the published 1.25 the two differ
    # by the tokens the forward drops, which is the layer's semantics.
    dropless = base.moe_num_experts / base.moe_top_k
    cfg = dataclasses.replace(base, num_layers=2, compute_dtype="float32",
                              moe_capacity_factor=dropless)
    summary_a = {"phase": "13a parity, 2 layers fp32, capacity factor "
                          f"{dropless:.4f} (E/k, dropless)",
                 **parity_run(cfg, 10, kernels)}
    print(json.dumps(summary_a), flush=True)
    n = cfg.num_layers
    check_launches(summary_a, {"flash_attention": n, "decode_attention": 0,
                               **norms_ropes(2 * n + 1, n)},
                   "launches_forward")
    check_launches(summary_a, {"flash_attention": n,
                               "decode_attention": n * 15,
                               **norms_ropes(2 * n + 1, n, 16)},
                   "launches_generate")
    # the published capacity factor: what a 4096-token prompt drops
    cfg = dataclasses.replace(cfg, moe_capacity_factor=
                              base.moe_capacity_factor)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    params = transformer.init_params(gen, cfg)
    prompt = torch.randint(0, cfg.vocab_size, (1, 4096), generator=gen,
                           device=dev, dtype=torch.int32)
    records = []
    with torch.no_grad(), moe_drops(records):
        transformer.forward(params, prompt, cfg)
    drops = {"phase": "13a drops at the published capacity factor",
             "capacity_factor": cfg.moe_capacity_factor, "tokens": 4096,
             "layers": [{"capacity": r["cap"],
                         "tokens_with_a_dropped_choice":
                             int((r["dropped"] > 0).sum()),
                         "choices_dropped": int(r["dropped"].sum()),
                         "choices": int(r["load"].sum()),
                         "expert_load": r["load"].tolist()}
                        for r in records]}
    print(json.dumps(drops), flush=True)
    del params, records
    torch.cuda.empty_cache()

    # (b) the whole model: 48 layers, bf16 weights and compute
    cfg = dataclasses.replace(base, param_dtype="bfloat16")
    summary_b = {"phase": "13b moonlight-16b-a3b, 48 layers bf16",
                 "decode_weight_floor": moe_weight_floor(cfg),
                 **whole_model_run(cfg, (11, 12), kernels,
                                   ("flash_wgmma_kernel",
                                    "flash_bf16_kernel"),
                                   ("decode_attention_kernel",))}
    print(json.dumps(summary_b), flush=True)
    n = cfg.num_layers
    check_launches(summary_b, {"flash_attention": n, "decode_attention": 0,
                               **norms_ropes(2 * n + 1, n)},
                   "launches_prefill")
    check_launches(summary_b, {"flash_attention": 0,
                               "decode_attention": n * 32,
                               **norms_ropes(2 * n + 1, n, 32)},
                   "launches_32_decode_steps")
    return summary_a, drops, summary_b


def jamba_phases(fa, da, ms, an, rp):
    """Phase 14: Jamba-v0.1 with its MoE; returns (a)'s and (b)'s
    summaries. Its whole 32 layers (103 GB in bf16) do not fit one card, so
    the depth is cut to whole periods of 8 layers: one in float32, two in
    bf16."""
    import dataclasses

    from repro_torch.configs import get_config

    base = dataclasses.replace(get_config("jamba_v0_1_52b"), remat=False,
                               attn_impl="pallas")
    kernels = {"flash_attention": fa.flash_attention,
               "decode_attention": da.decode_attention,
               "mamba_scan": ms.mamba_scan, "add_norm": an.add_norm,
               "rope": rp.rope}
    # (a) one period in float32, B 1, dropless as in 13(a)
    dropless = base.moe_num_experts / base.moe_top_k
    cfg = dataclasses.replace(base, num_layers=8, compute_dtype="float32",
                              moe_capacity_factor=dropless)
    summary_a = {"phase": "14a parity, 8 layers fp32 (one period, the depth "
                          f"cut), capacity factor {dropless:.1f} (E/k, "
                          "dropless)",
                 **parity_run(cfg, 13, kernels, batch=1)}
    print(json.dumps(summary_a), flush=True)
    check_launches(summary_a, {"flash_attention": 1, "decode_attention": 0,
                               "mamba_scan": 7, **norms_ropes(17, 1)},
                   "launches_forward")
    check_launches(summary_a, {"flash_attention": 1, "decode_attention": 15,
                               "mamba_scan": 7, **norms_ropes(17, 1, 16)},
                   "launches_generate")

    # (b) two periods in bf16
    cfg = dataclasses.replace(base, num_layers=16, param_dtype="bfloat16")
    summary_b = {"phase": "14b jamba-v0.1, 16 of 32 layers bf16 (the depth "
                          "cut: 103 GB whole)",
                 "decode_weight_floor": moe_weight_floor(cfg),
                 **whole_model_run(cfg, (14, 15), kernels,
                                   ("flash_wgmma_kernel",
                                    "flash_bf16_kernel", "mamba_scan"),
                                   ("decode_attention_kernel",))}
    print(json.dumps(summary_b), flush=True)
    check_launches(summary_b, {"flash_attention": 2, "decode_attention": 0,
                               "mamba_scan": 14, **norms_ropes(33, 2)},
                   "launches_prefill")
    check_launches(summary_b, {"flash_attention": 0, "decode_attention": 64,
                               "mamba_scan": 0, **norms_ropes(33, 2, 32)},
                   "launches_32_decode_steps")
    return summary_a, summary_b


def jamba2_stage_config():
    """Phase 14c's model: a Jamba2-Mini stage as one of its 8 cards holds
    it (the benchmark's ``jamba2_mini_l8e8_x5`` configuration)."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(
        get_config("jamba_v0_1_52b"), num_layers=8, param_dtype="bfloat16",
        tie_embeddings=False, norm_eps=1e-6, moe_experts_held=8,
        moe_dropless=True, moe_renormalize=False, attn_rope=False,
        ssm_dt_bc_norms=True, attn_impl="pallas", remat=False)


def expert_loop(x, order, offsets, weights, top_k, w_in, w_down):
    """The library yardstick of ``moe_grouped``: one pair of bf16
    ``torch.matmul`` products a held expert over its rows, each expert's
    count read on the host first (the synchronisation the kernel avoids)."""
    import torch.nn.functional as F

    d, ff = x.shape[-1], w_in.shape[-1]
    out = torch.zeros((order.shape[0], d), dtype=x.dtype, device=x.device)
    bounds = offsets.tolist()
    for e in range(len(bounds) - 1):
        pairs = order[bounds[e]:bounds[e + 1]]
        if not pairs.numel():
            continue
        gu = (x[pairs // top_k] @ w_in[e].view(d, 2 * ff)).view(-1, 2, ff)
        h = F.silu(gu[:, 0]) * gu[:, 1]
        out[pairs] = (h @ w_down[e]) * weights[pairs, None].to(x.dtype)
    return out


def jamba2_stage_phase(fa, ms, an, rp, mg, ref, forwards: int = 10):
    """Phase 14c; returns (the kernel's line, the forward's summary)."""
    from repro_torch.models import moe, transformer

    cfg = jamba2_stage_config()
    dev = torch.device("cuda")
    kernels = {"flash_attention": fa.flash_attention,
               "mamba_scan": ms.mamba_scan, "add_norm": an.add_norm,
               "rope": rp.rope, "moe_grouped": mg.moe_grouped}
    gen = torch.Generator(device=dev).manual_seed(31)
    params = transformer.init_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (8, 128), generator=gen,
                           device=dev, dtype=torch.int32)
    taken = []

    def keep_first(op):
        def call(*args):
            if not taken:
                taken.append(tuple(a.clone() if isinstance(a, torch.Tensor)
                                   else a for a in args))
            return op(*args)
        return call

    with torch.no_grad():
        transformer.forward(params, tokens, cfg)              # warm
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        with wrapped(moe, "moe_grouped_op", keep_first):
            logits, _ = transformer.forward(params, tokens, cfg)
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in kernels.items()}
    # add_norm: a norm before each mixer and each FFN and the final one,
    # and each Mamba mixer's dt, B and C norms
    want = {"flash_attention": 1, "mamba_scan": 7, "add_norm": 17 + 3 * 7,
            "rope": 0, "moe_grouped": 8}
    summary = {"phase": "14c jamba2-mini stage, 8 layers bf16, 8 of 16 "
                        "experts held, B 8 x S 128",
               "launches_forward": launches}
    check_launches(summary, want, "launches_forward")

    # (a) the kernel on the first MoE layer's arguments
    x, order, offsets, weights, top_k, w_in, w_down = taken[0]
    t, d = x.shape
    e, ff = w_in.shape[0], w_in.shape[-1]
    rows = int(offsets[-1])
    with torch.no_grad():
        got = mg.moe_grouped(x, order, offsets, weights, top_k, w_in, w_down)
        plain = ref.moe_grouped_ref(x, order, offsets, weights, top_k, w_in,
                                    w_down)
        torch.cuda.synchronize()
    held = torch.zeros(t * top_k, dtype=torch.bool, device=dev)
    held[order[:rows]] = True
    if got[~held].abs().max() != 0:
        raise AssertionError("14c: moe_grouped wrote a pair of an expert "
                             "not held")
    # float32 sums in another order, h's bf16 rounding falling the other
    # way for a few elements: the card test's tolerance
    g, w = got[held].double(), plain[held].double()
    live = w.abs().amax(-1) > 0
    rel = ((g - w).pow(2).mean(-1).sqrt()
           / w.pow(2).mean(-1).sqrt().clamp_min(1e-30))[live]
    if (g[~live] != 0).any() or rel.max() >= 1e-2:
        raise AssertionError(f"14c: moe_grouped against its plain version: "
                             f"worst row's relative RMS {rel.max().item()}")
    args = [(x, order, offsets, weights, top_k, w_in, w_down)]
    t_bytes = (e * 3 * d * ff + rows * 2 * (d + ff)) * 2 / HBM_BYTES_PER_S
    t_ops = 2 * rows * 3 * d * ff / BF16_OPS_PER_S
    with torch.no_grad():
        line = {"kernel": "moe_grouped",
                "shape": f"jamba2-mini stage's first MoE layer: {t} tokens, "
                         f"top-{top_k} of {cfg.moe_num_experts}, {e} held "
                         f"experts of d {d}, ff {ff}, {rows} held rows",
                "max_abs_err": (g - w).abs().max().item(),
                "max_rel_rms": rel.max().item(),
                "ms": time_ms(mg.moe_grouped, args, 20),
                "eager_ms": time_ms(mg.moe_grouped, args, 20, graph=False),
                "plain_ms": time_ms(ref.moe_grouped_ref, args, 2,
                                    graph=False),
                "library_ms": time_ms(expert_loop, args, 20, graph=False),
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "ops"}
    print(json.dumps(line), flush=True)
    del taken, got, plain, args

    # (b) the forward with the kernel and with the loop in its place
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def forward_ms():
        with torch.no_grad():
            transformer.forward(params, tokens, cfg)
            torch.cuda.synchronize()
            start.record()
            for _ in range(forwards):
                out, _ = transformer.forward(params, tokens, cfg)
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / forwards, out

    times = {"moe_grouped": [], "expert_loop": []}
    for _ in range(2):
        times["moe_grouped"].append(forward_ms()[0])
        with wrapped(moe, "moe_grouped_op", lambda op: expert_loop):
            ms_loop, loop_logits = forward_ms()
        times["expert_loop"].append(ms_loop)
    a, b = logits[:, -1].double(), loop_logits[:, -1].double()
    summary.update({
        "forward_ms": times,
        "forwards_a_reading": forwards,
        "last_logits_rel_rms_kernel_vs_loop":
            ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()})
    print(json.dumps(summary), flush=True)
    del params, logits, loop_logits
    torch.cuda.empty_cache()
    return line, summary


def audio_embeds(seed: int, batch: int, frames: int, d: int):
    """The stub frontend's frame embeddings, drawn with numpy."""
    emb = np.random.RandomState(seed).standard_normal((batch, frames, d))
    return torch.from_numpy(emb.astype(np.float32)).cuda()


def whisper_phases(fa, da):
    """Phase 16 at Whisper-medium's published width; returns (a)'s and
    (b)'s summaries."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.convert import flatten_params
    from repro_torch.models import encdec

    base = dataclasses.replace(get_config("whisper_medium"), remat=False,
                               attn_impl="pallas")
    kernels = {"flash_attention": fa.flash_attention,
               "decode_attention": da.decode_attention}
    dev = torch.device("cuda")
    frames = base.encoder_seq

    def counts():
        return {n: k.launches for n, k in kernels.items()}

    def since(before):
        return {n: k.launches - before[n] for n, k in kernels.items()}

    # (a) 2 + 2 layers in float32, B 2: the kernels' path against the plain
    # one (encode, teacher-forced logits), then prefill of 60 tokens and 4
    # greedy decode steps, each against the teacher-forced decoder
    cfg = dataclasses.replace(base, num_layers=2, encoder_layers=2,
                              compute_dtype="float32")
    plain_cfg = dataclasses.replace(cfg, attn_impl="xla")
    gen = torch.Generator(device=dev).manual_seed(16)
    params = encdec.init_params(gen, cfg)
    emb = audio_embeds(16, 2, frames, cfg.d_model)
    toks = torch.randint(0, cfg.logical_vocab_size, (2, 64), generator=gen,
                         device=dev, dtype=torch.int32)
    tol = 1e-4
    summary_a = {"phase": "16a parity, 2 + 2 layers fp32", "tol": tol}
    with torch.no_grad():
        before = counts()
        enc = encdec.encode(params, emb, cfg)
        summary_a["launches_encode"] = since(before)
        want_enc = encdec.encode(params, emb, plain_cfg)
        before = counts()
        got = encdec.decode_train(params, toks, emb, cfg)
        summary_a["launches_decode_train"] = since(before)
        want = encdec.decode_train(params, toks, emb, plain_cfg)
        for name, a, b in (("encode", enc, want_enc),
                           ("decode_train", got, want)):
            err = (a - b).abs().max().item()
            summary_a[f"{name}_max_abs_err"] = err
            if not torch.allclose(a, b, rtol=tol, atol=tol):
                raise AssertionError(f"16a {name}: kernels vs plain path, "
                                     f"max |err| {err} > tol {tol}")
        before = counts()
        last, cache = encdec.prefill(params, toks[:, :60], emb, cfg, 64)
        summary_a["launches_prefill"] = since(before)
        seq, step_err = toks[:, :60], 0.0
        before = counts()
        for pos in range(60, 64):
            tok = torch.argmax(last, -1)[:, None].to(torch.int32)
            seq = torch.cat([seq, tok], dim=1)
            last, cache = encdec.decode_step(params, tok, pos, cache, cfg)
            full = encdec.decode_train(params, seq, emb, cfg)[:, -1]
            step_err = max(step_err, (last - full).abs().max().item())
            if not torch.allclose(last, full, rtol=2e-4, atol=2e-4):
                raise AssertionError(f"16a decode step at {pos}: max |err| "
                                     f"{step_err} against the teacher-forced "
                                     "decoder")
        summary_a["decode_step_vs_teacher_forcing_max_abs_err"] = step_err
    print(json.dumps(summary_a), flush=True)
    check_launches(summary_a, {"flash_attention": 2, "decode_attention": 0},
                   "launches_encode")
    check_launches(summary_a, {"flash_attention": 6, "decode_attention": 0},
                   "launches_decode_train")
    check_launches(summary_a, {"flash_attention": 6, "decode_attention": 0},
                   "launches_prefill")
    del params, cache, enc, want_enc, got, want
    torch.cuda.empty_cache()

    # (b) the whole model in bf16: B 1, 1500 frames, a 64-token prompt and
    # 32 decode steps
    cfg = dataclasses.replace(base, param_dtype="bfloat16")
    params = encdec.init_params(torch.Generator(device=dev).manual_seed(17),
                                cfg)
    flat = flatten_params(params)
    n_params = sum(t.numel() for t in flat.values())
    nbytes = sum(t.numel() * t.element_size() for t in flat.values())
    del flat
    emb = audio_embeds(17, 1, frames, cfg.d_model)
    prompt = torch.randint(0, cfg.logical_vocab_size, (1, 64), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               18), dtype=torch.int32)
    width, steps = 64 + 32, 32
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def decode_loop(logits, cache, n):
        tok = torch.argmax(logits, -1).to(torch.int32)
        for i in range(n):
            logits, cache = encdec.decode_step(params, tok[:, None], 64 + i,
                                               cache, cfg)
            tok = torch.argmax(logits, -1).to(torch.int32)
        return logits

    def timed(fn):
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    names = ("flash_wgmma_kernel", "flash_bf16_kernel",
             "decode_attention_kernel")
    with torch.no_grad():
        encdec.prefill(params, prompt, emb, cfg, width)          # warm
        torch.cuda.synchronize()
        _, encode_ms = timed(lambda: encdec.encode(params, emb, cfg))
        before = counts()
        (logits, cache), prefill_ms = timed(
            lambda: encdec.prefill(params, prompt, emb, cfg, width))
        at_prefill = since(before)
        before = counts()
        last, decode_ms = timed(lambda: decode_loop(logits, cache, steps))
        in_decode = since(before)
        if not torch.isfinite(last.float()).all():
            raise AssertionError("non-finite logits after 32 decode steps")
        pre_split, pre_other = family_split(
            lambda: encdec.prefill(params, prompt, emb, cfg, width), names)
        logits, cache = encdec.prefill(params, prompt, emb, cfg, width)
        dec_split, dec_other = family_split(
            lambda: decode_loop(logits, cache, 8), names)
    del params, cache, logits
    torch.cuda.empty_cache()
    summary_b = {"phase": "16b whisper-medium, 24 + 24 layers bf16",
                 "params": n_params, "weights_gb": nbytes / 1e9,
                 "frames": frames, "prompt": 64, "encode_ms": encode_ms,
                 "prefill_ms": prefill_ms,
                 "decode_ms_per_token": decode_ms / steps,
                 "launches_prefill": at_prefill,
                 "launches_32_decode_steps": in_decode,
                 "prefill_device_ms_by_kernel": pre_split,
                 "prefill_other_top_ms": pre_other,
                 "decode_step_device_ms_by_kernel":
                     {k: v / 8 for k, v in dec_split.items()},
                 "decode_other_top_ms": {k: v / 8
                                         for k, v in dec_other.items()}}
    print(json.dumps(summary_b), flush=True)
    check_launches(summary_b, {"flash_attention": 3 * cfg.num_layers,
                               "decode_attention": 0}, "launches_prefill")
    check_launches(summary_b, {"flash_attention": cfg.num_layers * steps,
                               "decode_attention": cfg.num_layers * steps},
                   "launches_32_decode_steps")
    return summary_a, summary_b


# --------------------------------------------------------------------------- #
# phase 17: training on the card
# --------------------------------------------------------------------------- #

# 17a: one float32 step on the card (TF32 off) against the same step on the
# host, by the port's own code. The gradients' sums run in other orders
# over reductions of up to 12288 terms (d_ff) and 128 tokens, so each
# gradient leaf is held to 2e-4 of its largest |g| (``mu`` after one step
# is 0.1 x the clipped gradient, ``nu`` 0.05 x its square: twice the
# relative error), the loss to 2e-5 and the grad norm to 2e-4 relative; the
# parameters move by lr_0 (3e-6) times mhat / (sqrt(vhat) + eps), +-1 where
# |g| >> eps, and are held within 2 lr_0 (a near-zero gradient's sign).
TRAIN_PARITY_TOL = {"loss": 2e-5, "grad_norm": 2e-4, "mu": 2e-4, "nu": 4e-4}


def tree_to(tree, device):
    from repro_torch.training.tree import tree_map

    return tree_map(lambda t: t.detach().to(device, copy=True), tree)


def state_bytes(tree) -> int:
    from repro_torch.training.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree))


def train_steps(step_fn, params, opt, batch, steps: int, tokens: int,
                n_params: int) -> tuple:
    """``steps`` steps of ``step_fn`` on one repeated batch, each timed on
    the host clock (ending in a synchronize) and by CUDA events, with the
    optimizer's share by CUDA events around ``adamw_update``; the loss (and
    aux loss) of each step, the peak memory from the first step on, the
    memory allocated just before the first step and the step's argument
    bytes (params, moments and batch), so that phase 20 can take the
    steps' own peak. Fails unless the loss is finite and falls. Returns
    (summary, params, opt state)."""
    from repro_torch.training import train_loop

    opt_events = []

    def timed_update(original):
        def update(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = original(*args, **kw)
            b.record()
            opt_events.append((a, b))
            return out
        return update

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    arguments = state_bytes((params, opt, batch))
    rows = []
    with wrapped(train_loop, "adamw_update", timed_update):
        for _ in range(steps):
            t0 = time.perf_counter()
            start.record()
            params, opt, m = step_fn(params, opt, batch)
            end.record()
            end.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            a, b = opt_events[-1]
            rows.append({"wall_ms": wall,
                         "device_ms": start.elapsed_time(end),
                         "optimizer_ms": a.elapsed_time(b),
                         **{k: float(v) for k, v in m.items()}})
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    steady = rows[1:]
    wall = sorted(r["wall_ms"] for r in steady)[len(steady) // 2]
    peak = torch.cuda.max_memory_allocated()
    return {"steps": rows, "peak_gb": peak / 1e9,
            "peak_bytes": peak, "allocated_before_steps_bytes": before,
            "step_argument_bytes": arguments,
            # the steps' own peak: less what was allocated before them
            # that is not one of their arguments
            "step_peak_bytes": peak - (before - arguments),
            "median_wall_ms": wall,
            "median_device_ms": sorted(r["device_ms"] for r in steady)[
                len(steady) // 2],
            "tokens_per_step": tokens, "tokens_per_s": tokens / wall * 1e3,
            "utilisation_6NT": 6 * n_params * tokens / (wall / 1e3)
                               / BF16_OPS_PER_S}, params, opt


def parity_train_step(base, label: str) -> dict:
    """17a (StarCoder2-3B) and 17g (Falcon-Mamba-7B): ``base`` at full
    width, 2 layers, float32 compute, remat on, B 2 x S 64: one step on
    the card and one on the host from the same parameters and batch."""
    import dataclasses

    from repro_torch.data import make_batch_for
    from repro_torch.models import transformer
    from repro_torch.training import adamw_init
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.training.tree import leaves_with_names

    cfg = dataclasses.replace(base, num_layers=2, compute_dtype="float32")
    dev = torch.device("cuda")
    params = transformer.init_params(
        torch.Generator(device=dev).manual_seed(20), cfg)
    host = tree_to(params, "cpu")
    batch = make_batch_for(cfg, 2, 64, seed=20)
    step = make_train_step(cfg)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    for key, where, p in (("card", dev, params), ("host", "cpu", host)):
        data = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        p, o, m = step(p, adamw_init(p), data)
        out[key] = (tree_to({"params": p, "opt_state": o}, "cpu"),
                    {k: float(v) for k, v in m.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tol = TRAIN_PARITY_TOL
    lr0 = AdamWConfig().lr / AdamWConfig().warmup_steps
    summary = {"phase": label,
               "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
               "tol": tol, "params_atol": 2 * lr0, "peak_gb": peak_gb,
               "metrics_card": out["card"][1], "metrics_host": out["host"][1]}
    for k in ("loss", "grad_norm"):
        a, b = out["card"][1][k], out["host"][1][k]
        summary[f"{k}_rel_err"] = abs(a - b) / abs(b)
        if abs(a - b) > tol[k] * abs(b):
            raise AssertionError(f"{label} {k}: card {a} against host {b}")
    worst = {"mu": 0.0, "nu": 0.0, "params_abs": 0.0}
    for (name, a), (_, b) in zip(leaves_with_names(out["card"][0]),
                                 leaves_with_names(out["host"][0])):
        if ".step" in name:
            continue
        err = (a.float() - b.float()).abs().max().item()
        if name.startswith("['params']"):
            worst["params_abs"] = max(worst["params_abs"], err)
            if err > 2 * lr0:
                raise AssertionError(f"{label} {name}: |err| {err} > "
                                     f"{2 * lr0}")
            continue
        kind = "mu" if ".mu" in name else "nu"
        rel = err / max(b.abs().max().item(), 1e-30)
        worst[kind] = max(worst[kind], rel)
        if rel > tol[kind]:
            raise AssertionError(f"{label} {name}: |err| {rel} of the "
                                 f"leaf's largest, > {tol[kind]}")
    summary["max_err"] = worst
    print(json.dumps(summary), flush=True)
    del params, host, out
    return summary


def run_driver(fn, argv) -> tuple:
    """A launch driver's ``main(argv)`` with its output captured and then
    echoed: (its return value, the output, {wall seconds, peak device
    memory, the driver's last tokens/s})."""
    import io
    import re

    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    log = buf.getvalue()
    stats = {"wall_s": time.perf_counter() - t0,
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "tok_s": float(re.findall(r"([\d,]+) tok/s",
                                       log)[-1].replace(",", ""))}
    print(log, end="", flush=True)
    return out, log, stats


def whole(label, cfg, step_fn, batch, steps, tokens, seed,
          profile=False, live_count=False) -> dict:
    """``steps`` train steps of ``cfg`` (``train_steps``) from parameters
    drawn from ``seed`` on the card, with the state's sizes and, with
    ``profile``, one more step's device time by kernel family; with
    ``live_count``, one more step under the dry run's counter
    (``dryrun.trace_step`` on the card's tensors: its live bytes, the
    backward's on the autograd engine's device thread included)."""
    from repro_torch.training.train_loop import init_train_state
    from repro_torch.training.tree import leaves

    params, opt = init_train_state(
        torch.Generator(device="cuda").manual_seed(seed), cfg)
    n_params = sum(t.numel() for t in leaves(params))
    # a gradient leaf has its parameter's shape and dtype
    sizes = {"params_gb": state_bytes(params) / 1e9,
             "grads_gb": state_bytes(params) / 1e9,
             "mu_gb": state_bytes(opt.mu) / 1e9,
             "nu_gb": state_bytes(opt.nu) / 1e9}
    summary, params, opt = train_steps(step_fn, params, opt, batch, steps,
                                       tokens, n_params)
    summary = {"phase": label, "card": card_line(), "params": n_params,
               **sizes, **summary}
    if profile:             # one more step, by kernel family
        split, other = family_split(
            lambda: step_fn(params, opt, batch), (), n_other=8)
        summary["step_device_ms_by_family"] = split
        summary["step_other_top_ms"] = other
    if live_count:
        from repro_torch.launch.dryrun import trace_step

        stats = trace_step(step_fn, params, opt, batch)
        summary["live_count"] = {k: stats[k] for k in (
            "peak_bytes", "temp_bytes", "bytes_accessed", "argument_bytes",
            "lower_s")}
    print(json.dumps(summary), flush=True)
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def training_phases() -> dict:
    """Phase 17: the port's training path on the card; returns the
    summaries by sub-phase."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset, make_batch_for
    from repro_torch.kernels import ops
    from repro_torch.launch import train, train_100m
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step,
                                                 make_whisper_train_step)

    dev = torch.device("cuda")
    base = dataclasses.replace(get_config("starcoder2_3b"), remat=True,
                               attn_impl="xla")
    out = {}
    card = card_line()

    phase("17a one train step, card against host, float32")
    out["17a"] = parity_train_step(
        base, "17a parity, 2 layers fp32, card against host")
    gc.collect()
    torch.cuda.empty_cache()

    phase("17b StarCoder2-3B whole, 30 layers, B 1 x S 4096")
    cfg = train_configs()["17b"]        # base: phase 20 traces this step
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=4096,
                            global_batch=1, seed=0, branching=2)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch(0).items()}
    out["17b"] = whole("17b starcoder2-3b, 30 layers, fp32 params, bf16 "
                       "compute, remat", cfg, make_train_step(cfg), batch, 6,
                       4096, 21, profile=True, live_count=True)

    phase("17c Whisper-medium whole, 24 + 24 layers, B 2, 1500 frames, "
          "448 tokens")
    cfg = dataclasses.replace(get_config("whisper_medium"), remat=True)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in make_batch_for(cfg, 2, 448, seed=22).items()}
    out["17c"] = whole("17c whisper-medium, 24 + 24 layers, fp32 params, "
                       "bf16 compute, remat", cfg,
                       make_whisper_train_step(cfg), batch, 4, 2 * 448, 22)

    phase("17d Moonlight-16B-A3B at full width, 2 layers, B 1 x S 4096")
    cfg = dataclasses.replace(get_config("moonshot_v1_16b_a3b"),
                              num_layers=2, remat=True)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=4096,
                            global_batch=1, seed=0, branching=2)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch(0).items()}
    out["17d"] = whole("17d moonlight-16b-a3b, 2 layers, fp32 params, bf16 "
                       "compute, remat", cfg, make_train_step(cfg), batch, 3,
                       4096, 23)
    aux = [r["aux_loss"] for r in out["17d"]["steps"]]
    if not all(math.isfinite(a) and a > 0 for a in aux):
        raise AssertionError(f"17d aux loss not positive and finite: {aux}")

    phase("17e the training driver: 100m preset, resume, int8-EF grads")
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        ckpt = os.path.join(root, "100m")
        (_, ok), log, stats = run_driver(train_100m.main, [
            "--ckpt-dir", ckpt, "--device", "cuda"])
        if not ok or "OK: loss decreased" not in log:
            raise AssertionError("train_100m: the loss did not decrease")
        runs = {"train_100m": {"steps": 300, **stats}}
        common = ["--preset", "100m", "--batch", "8", "--seq", "256",
                  "--ckpt-every", "50", "--log-every", "10",
                  "--device", "cuda"]
        history, log, stats = run_driver(train.main, common + [
            "--ckpt-dir", ckpt, "--steps", "360", "--resume"])
        if "[train] resumed from step 300" not in log or \
                history[0]["step"] != 301:
            raise AssertionError("the resumed run did not start at step 300")
        runs["resume_to_360"] = {"steps": 60, **stats}
        history, log, stats = run_driver(train.main, common + [
            "--ckpt-dir", os.path.join(root, "ef"), "--steps", "60",
            "--compress"])
        if not history[-1]["loss"] < history[0]["loss"]:
            raise AssertionError("the int8-EF run's loss did not fall")
        runs["compress_60"] = {"steps": 60, **stats,
                               "loss": [history[0]["loss"],
                                        history[-1]["loss"]]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["17e"] = {"phase": "17e the training driver", "card": card,
                  "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                  **runs}
    print(json.dumps(out["17e"]), flush=True)

    phase("17f the kernels refuse a differentiable call")
    q = torch.randn(1, 24, 64, 128, device=dev, requires_grad=True)
    kv = torch.randn(1, 2, 64, 128, device=dev)
    refused = []
    try:
        ops.flash_attention_op(q, kv, kv)
    except RuntimeError as e:
        refused.append(str(e))
    cfg = dataclasses.replace(base, num_layers=2, attn_impl="pallas")
    params, opt = init_train_state(
        torch.Generator(device=dev).manual_seed(24), cfg)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in make_batch_for(cfg, 1, 64, seed=24).items()}
    try:
        make_train_step(cfg)(params, opt, batch)
    except RuntimeError as e:
        refused.append(str(e))
    del params, opt
    torch.cuda.empty_cache()
    out["17f"] = {"phase": "17f refusals", "refused": refused}
    print(json.dumps(out["17f"]), flush=True)
    if len(refused) != 2 or not all("has no backward" in r
                                    for r in refused):
        raise AssertionError(f"17f: {len(refused)} of 2 calls refused")
    out.update(falcon_training())
    return out


def falcon_training() -> dict:
    """17g and 17h: Falcon-Mamba-7B training through the chunked scan
    (``models/ssm.py``), float32 params and moments, remat on."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.training.train_loop import make_train_step

    dev = torch.device("cuda")
    base = dataclasses.replace(get_config("falcon_mamba_7b"), remat=True,
                               attn_impl="xla")
    out = {}
    phase("17g one Falcon-Mamba-7B train step, card against host, float32")
    out["17g"] = parity_train_step(
        base, "17g falcon-mamba-7b parity, 2 layers fp32, card against host")
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"17h Falcon-Mamba-7B at full width, {FALCON_TRAIN_LAYERS} of 64 "
          "layers, B 1 x S 4096")
    cfg = train_configs()["17h"]        # phase 20 traces this step
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=4096,
                            global_batch=1, seed=0, branching=2)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch(0).items()}
    out["17h"] = whole(f"17h falcon-mamba-7b, {FALCON_TRAIN_LAYERS} layers, "
                       "fp32 params, bf16 compute, remat", cfg,
                       make_train_step(cfg), batch, 4, 4096, 25,
                       profile=True)
    out["17h_layer"] = scan_paths_one_layer(base)
    return out


# 17h: Falcon-Mamba-7B's depth cut from 64 to 32 layers so that float32
# params, grads, mu and nu (3.64 B parameters, 16 bytes each) fit one card
FALCON_TRAIN_LAYERS = 32


def scan_paths_one_layer(base, steps: int = 3) -> dict:
    """One Falcon-Mamba-7B layer at full width (bf16 compute, float32
    params), B 1 x S 4096: forward + backward through the chunked scan and
    through the stepped recurrence the plain path ran before it
    (``mamba_scan_ref`` under autograd), each timed by CUDA events (the
    median of ``steps`` after a warm-up), on the same weights and input."""
    from repro_torch.kernels.ref import mamba_scan_ref
    from repro_torch.models import ssm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    params = {k: v.requires_grad_(True)
              for k, v in ssm.init_mamba(gen, base, torch.float32).items()}
    x = (torch.randn((1, 4096, base.d_model), generator=gen, device=dev)
         ).to(torch.bfloat16).requires_grad_(True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def stepped(x, dt, b_mat, c_mat, a, d_vec, chunk, h0=None):
        return mamba_scan_ref(x, dt, b_mat, c_mat, a, d_vec, h0=h0)

    def run():
        y, _ = ssm.mamba_forward(params, x, base, torch.bfloat16)
        y.float().square().mean().backward()

    out = {"phase": "17h one layer, forward + backward, B 1 x S 4096",
           "card": card_line()}
    for name, scan in (("chunked_scan", ssm.chunked_scan),
                       ("stepped_mamba_scan_ref", stepped)):
        with wrapped(ssm, "chunked_scan", lambda _: scan):
            run()
            times = []
            torch.cuda.reset_peak_memory_stats()
            for _ in range(steps):
                start.record()
                run()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
        out[f"{name}_ms"] = sorted(times)[len(times) // 2]
        out[f"{name}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["stepped_over_chunked"] = out["stepped_mamba_scan_ref_ms"] \
        / out["chunked_scan_ms"]
    print(json.dumps(out), flush=True)
    del params, x
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# phases 18-19: the sharding layer
# --------------------------------------------------------------------------- #

# phase 18's cells: (arch, shape, multi-pod)
DRYRUN_CELLS = (("starcoder2_3b", "train_4k", False),
                ("falcon_mamba_7b", "prefill_32k", False),
                ("mixtral_8x22b", "train_4k", False),
                ("whisper_medium", "decode_32k", False),
                ("starcoder2_3b", "decode_32k", True),
                ("minitron_8b", "train_4k", False),
                ("minitron_8b", "prefill_32k", False))
DRYRUN_TIMEOUT_S = 420
# every cell's per-device peak must fit one H100 (80 GB)
DRYRUN_PEAK_LIMIT = 80e9
# StarCoder2-3B x train_4k's flops a device: the reference's 95.6 T and a
# margin, the row-parallel products' gradients split over the model axis
# (computed whole on every rank of it, the cell took 287.4 T)
STARCODER_TRAIN_FLOPS_LIMIT = 130e12
# its all-gather bytes a device: the reference's 33.8 GB and a margin (on a
# "cpu"-typed mesh, whose shard-to-shard moves gather whole dims, 441 GB)
STARCODER_TRAIN_ALL_GATHER_LIMIT = 100e9
# the mesh type of a card run, which the dry run's meshes must have
DRYRUN_MESH_TYPE = "cuda"


def start_dryrun(out_dir: str) -> list:
    """Phase 18's cells, each ``python -m repro_torch.launch.dryrun`` in a
    process of its own (its fake process group of 512 ranks is that
    process's default group), all started together on the host's cores;
    none touches the card."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape, multi_pod in DRYRUN_CELLS:
        out = os.path.join(out_dir, f"{arch}_{shape}_{int(multi_pod)}.json")
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                arch, "--shape", shape, "--out", out] + (
                    ["--multi-pod"] if multi_pod else [])
        log = open(out + ".log", "w")
        procs.append((subprocess.Popen(argv, env=env, cwd=ROOT, stdout=log,
                                       stderr=subprocess.STDOUT), out, log,
                      time.perf_counter()))
    return procs


def wait_within_limit(proc, t0: float) -> int:
    """``proc``'s exit code, the process killed past ``DRYRUN_TIMEOUT_S``
    from its start ``t0``."""
    try:
        return proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                                     - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait()


def finish_dryrun(procs: list) -> list:
    """Waits for phase 18's cells (each within ``DRYRUN_TIMEOUT_S`` of its
    start, killed past it), prints one JSON line per cell, then each
    cell's collective bytes by kind, and fails if any cell failed, left
    ``peak_bytes`` or ``bytes_accessed`` null, peaked over
    ``DRYRUN_PEAK_LIMIT`` a device, ran on a mesh not typed
    ``DRYRUN_MESH_TYPE`` or started CUDA, or (StarCoder2-3B x train_4k)
    counted more than ``STARCODER_TRAIN_FLOPS_LIMIT`` or
    ``STARCODER_TRAIN_ALL_GATHER_LIMIT``, or no all-to-all."""
    results, failed = [], []
    for proc, out, log, t0 in procs:
        rc = wait_within_limit(proc, t0)
        log.close()
        cell = {"ok": False, "rc": rc}
        if os.path.exists(out):
            with open(out) as f:
                cell = {**json.load(f)[0], "rc": rc}
        line = {"phase": "18 dry run", **{k: cell.get(k) for k in (
            "arch", "shape", "mesh", "ok", "lower_s", "flops",
            "argument_bytes", "output_bytes", "peak_bytes", "temp_bytes",
            "bytes_accessed", "collective_bytes", "collective_counts",
            "mesh_device_type", "cuda_initialized", "error", "rc")},
            "peak_limit_bytes": DRYRUN_PEAK_LIMIT}
        starcoder_train = (line["arch"], line["shape"], line["mesh"]) == (
            "starcoder2_3b", "train_4k", [16, 16])
        if starcoder_train:
            line["flops_limit"] = STARCODER_TRAIN_FLOPS_LIMIT
            line["all_gather_limit_bytes"] = STARCODER_TRAIN_ALL_GATHER_LIMIT
        print(json.dumps(line), flush=True)
        results.append(line)
        coll = line["collective_bytes"] or {}
        if rc != 0 or not cell.get("ok") or line["peak_bytes"] is None \
                or line["bytes_accessed"] is None:
            with open(out + ".log") as f:
                print(f.read()[-3000:], flush=True)
            failed.append(out)
        elif line["peak_bytes"] > DRYRUN_PEAK_LIMIT:
            failed.append(f"{out}: peak {line['peak_bytes']} B")
        elif line["mesh_device_type"] != DRYRUN_MESH_TYPE:
            failed.append(f"{out}: a {line['mesh_device_type']!r} mesh")
        elif line["cuda_initialized"] is not False:
            failed.append(f"{out}: CUDA started ({line['cuda_initialized']})")
        elif starcoder_train and (
                line["flops"] > STARCODER_TRAIN_FLOPS_LIMIT
                or coll.get("all-gather", 0) > STARCODER_TRAIN_ALL_GATHER_LIMIT
                or not coll.get("all-to-all")):
            failed.append(f"{out}: {line['flops']} flops, collectives "
                          f"{coll}")
    # each cell's collective bytes a device by kind, in GB
    kinds = ("all-gather", "all-to-all", "reduce-scatter", "all-reduce")
    for line in results:
        coll = line["collective_bytes"] or {}
        print(f"  {line['arch']} x {line['shape']} x "
              f"{'x'.join(map(str, line['mesh'] or []))} "
              f"({line['mesh_device_type']} mesh): " + ", ".join(
                  f"{k} {coll.get(k, 0) / 1e9:.3f} GB" for k in kinds),
              flush=True)
    if failed:
        raise AssertionError(f"18: dry-run cells failed: {failed}")
    return results


# --------------------------------------------------------------------------- #
# phase 20: the dry run's memory against the card
# --------------------------------------------------------------------------- #

META_PEAKS_FLAG = "--meta-train-peaks"
# the meta trace's peak against the card's, as a share of the card's
MEMORY_TOL = 0.05


def train_configs() -> dict:
    """17b's and 17h's configs, by sub-phase."""
    import dataclasses

    from repro_torch.configs import get_config

    def train(arch, **cuts):
        return dataclasses.replace(get_config(arch), remat=True,
                                   attn_impl="xla", **cuts)

    return {"17b": train("starcoder2_3b"),
            "17h": train("falcon_mamba_7b", num_layers=FALCON_TRAIN_LAYERS)}


def meta_train_peaks(out_path: str) -> int:
    """Phase 20's trace, run by ``chip_smoke.py --meta-train-peaks OUT``
    in a process of its own on the host's CPU: 17b's and 17h's train
    steps (``make_train_step``, B 1 x S 4096) through
    ``dryrun.trace_step`` on meta params, moments and batch of the card
    run's shapes and dtypes; the keys of each go to ``out_path``."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.models import transformer
    from repro_torch.training import adamw_init
    from repro_torch.training.train_loop import make_train_step

    out = {}
    for key, cfg in train_configs().items():
        params = transformer.abstract_params(cfg)
        ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=4096,
                                global_batch=1, seed=0, branching=2)
        batch = {k: torch.from_numpy(v).to("meta")
                 for k, v in ds.batch(0).items()}
        out[key] = trace_step(make_train_step(cfg), params,
                              adamw_init(params), batch)
        print(key, json.dumps(out[key]), flush=True)
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def start_memory_trace(out_dir: str) -> tuple:
    """Phase 20's trace in a process of its own (CUDA hidden), started
    with phase 18's cells."""
    out = os.path.join(out_dir, "meta_train_peaks.json")
    log = open(out + ".log", "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), META_PEAKS_FLAG, out],
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), cwd=ROOT, stdout=log,
        stderr=subprocess.STDOUT)
    return proc, out, log, time.perf_counter()


def memory_phase(trace, training: dict) -> None:
    """Phase 20: each meta-traced ``peak_bytes`` of 17b's and 17h's step
    against the peak the card measured for those steps (17's
    ``step_peak_bytes``: ``max_memory_allocated()`` over the steps less
    what was allocated before them that is not one of their arguments),
    within ``MEMORY_TOL`` of the card's; beside 17b's, the live count of
    one real step on the card. The meta trace's arguments must be the
    card's bytes."""
    proc, out, log, t0 = trace
    rc = wait_within_limit(proc, t0)
    log.close()
    if rc != 0 or not os.path.exists(out):
        with open(out + ".log") as f:
            print(f.read()[-3000:], flush=True)
        raise AssertionError(f"20: the meta trace exited with {rc}")
    with open(out) as f:
        traced = json.load(f)
    bad = []
    for key in ("17b", "17h"):
        card = training[key]
        meta = traced[key]
        diff = meta["peak_bytes"] - card["step_peak_bytes"]
        line = {"phase": f"20 {key}: the meta trace's peak against the "
                         "card's",
                "card": card["card"],
                "meta_peak_bytes": meta["peak_bytes"],
                "card_step_peak_bytes": card["step_peak_bytes"],
                "diff_bytes": diff,
                "diff_of_card": diff / card["step_peak_bytes"],
                "tol": MEMORY_TOL,
                "meta_temp_bytes": meta["temp_bytes"],
                "meta_bytes_accessed": meta["bytes_accessed"],
                "meta_argument_bytes": meta["argument_bytes"],
                "card_argument_bytes": card["step_argument_bytes"],
                "card_max_memory_allocated_bytes": card["peak_bytes"],
                "card_allocated_before_steps_bytes":
                    card["allocated_before_steps_bytes"],
                "meta_trace_s": meta["lower_s"]}
        if "live_count" in card:
            live = card["live_count"]
            line["card_live_count_peak_bytes"] = live["peak_bytes"]
            line["card_live_count_diff_of_card"] = \
                (live["peak_bytes"] - card["step_peak_bytes"]) \
                / card["step_peak_bytes"]
            line["card_live_count_step_s"] = live["lower_s"]
            if abs(line["card_live_count_diff_of_card"]) > MEMORY_TOL:
                bad.append(f"{key} live count")
        print(json.dumps(line), flush=True)
        if abs(diff) > MEMORY_TOL * card["step_peak_bytes"]:
            bad.append(key)
        if meta["argument_bytes"] != card["step_argument_bytes"]:
            bad.append(f"{key} arguments")
    if bad:
        raise AssertionError(f"20: outside {MEMORY_TOL:.0%} of the card's "
                             f"peak, or other arguments: {bad}")


LOCAL_MESH_FLAG = "--local-mesh-step"


def local_mesh_step() -> int:
    """Phase 19's body, run by ``chip_smoke.py --local-mesh-step`` in a
    process of its own: StarCoder2-3B at full width, 2 layers, float32,
    one train step with the parameters as DTensors on the card's 1x1 mesh
    (``make_local_mesh()``: NCCL, one rank) under the train rules, and the
    plain step on the same card from the same parameters and batch; loss,
    grad norm, ``mu``, ``nu`` and parameters held as in 17a."""
    import copy
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_for
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer
    from repro_torch.sharding.logical import rules_for, use_rules
    from repro_torch.sharding.partition import (distribute_tree,
                                                param_shardings)
    from repro_torch.training import adamw_init
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.training.tree import leaves_with_names

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("starcoder2_3b"), num_layers=2,
                              remat=True, attn_impl="xla",
                              compute_dtype="float32")
    dev = torch.device("cuda")
    mesh = make_local_mesh()
    rules = rules_for(cfg, mesh, "train")
    step = make_train_step(cfg)
    params = transformer.init_params(
        torch.Generator(device=dev).manual_seed(27), cfg)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in make_batch_for(cfg, 2, 64, seed=27).items()}
    plain = copy.deepcopy(params)
    p0, o0, m0 = step(plain, adamw_init(plain), batch)
    sharded = distribute_tree(params, param_shardings(
        params, transformer.param_axes(cfg), mesh, rules))
    with use_rules(rules, mesh), implicit_replication():
        p1, o1, m1 = step(sharded, adamw_init(sharded), batch)
    tol = TRAIN_PARITY_TOL
    lr0 = AdamWConfig().lr / AdamWConfig().warmup_steps
    summary = {"phase": "19 local mesh, StarCoder2-3B 2 layers fp32, "
                        "DTensor params against the plain step",
               "card": card_line(), "mesh": list(mesh.shape),
               "backend": dist.get_backend(), "tol": tol,
               "metrics_plain": {k: float(v) for k, v in m0.items()},
               "metrics_mesh": {k: float(v) for k, v in m1.items()}}
    bad = []
    for k in ("loss", "grad_norm"):
        a, b = summary["metrics_mesh"][k], summary["metrics_plain"][k]
        summary[f"{k}_rel_err"] = abs(a - b) / abs(b)
        if abs(a - b) > tol[k] * abs(b):
            bad.append(k)
    worst = {"mu": 0.0, "nu": 0.0, "params_abs": 0.0}
    for (name, a), (_, b) in zip(leaves_with_names((p0, o0)),
                                 leaves_with_names((p1, o1))):
        if ".step" in name:
            continue
        if not isinstance(b, DTensor):
            bad.append(f"{name} is not a DTensor")
            continue
        err = (a.float() - b.full_tensor().float()).abs().max().item()
        if name.startswith("[0]"):
            worst["params_abs"] = max(worst["params_abs"], err)
            if err > 2 * lr0:
                bad.append(name)
            continue
        kind = "mu" if ".mu" in name else "nu"
        rel = err / max(a.abs().max().item(), 1e-30)
        worst[kind] = max(worst[kind], rel)
        if rel > tol[kind]:
            bad.append(name)
    summary["max_err"] = worst
    summary["failed"] = bad
    print(json.dumps(summary), flush=True)
    dist.destroy_process_group()
    return 1 if bad else 0


def local_mesh_phase() -> None:
    """Phase 19 in a process of its own (a process group is its process's
    default group); fails unless it exits with 0."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          LOCAL_MESH_FLAG], cwd=ROOT, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"19: the local-mesh step exited with "
                             f"{out.returncode}")


def mem_available_gb() -> float:
    """The host's MemAvailable (``/proc/meminfo``), in GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def kernel_entry(name, source, replaces, launches, line) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": line["max_abs_err"], "ms": line["ms"],
            "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
            "bound_by": line["bound_by"], "library_ms": line["library_ms"],
            "shape": line["shape"],
            **({"kernel_route": line["route"]} if "route" in line else {})}


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

    from repro_torch.kernels import add_norm as an
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import moe_grouped as mg
    from repro_torch.kernels import ref
    from repro_torch.kernels import rope as rp
    from repro_torch.launch import serve, serve_real_experts

    phase("2 build")
    build_all()

    phase("3 decode kernel vs plain")
    lines = kernel_vs_plain(da, ref)
    two_streams(da, ref)
    two_graphs(da, ref)

    phase("4 serving with decode (the first slice's main path)")
    decode_launches = serve_decode(serve, da, [
        "--mode", "real", "--decode", "--requests", "40", "--quiet"])

    phase("5 serving with decode, phi4-mini ring geometry")
    serve_decode(serve, da, ["--mode", "real", "--decode", "--requests",
                             "40", "--quiet"], ring=PHI4_RING)

    phase("6 serving without decode, and the serving example's twin")
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
    # the serving example's twin: 150 requests under COSERVE and SAMBA
    for policy, m in serve_real_experts.main(["--device", "cuda"]).items():
        print(json.dumps({"serve_real_experts": policy,
                          "completed": m.completed, "switches": m.switches,
                          "makespan_s": m.makespan}), flush=True)
        if m.completed != serve_real_experts.N_REQS:
            raise AssertionError(f"serve_real_experts {policy}: "
                                 f"{m.completed} of "
                                 f"{serve_real_experts.N_REQS} completed")

    phase("7 flash kernel vs plain")
    flash_lines = flash_vs_plain(fa, ref)

    phase("7b norm and RoPE kernels vs plain (no TPU counterpart)")
    norm_lines, rope_lines = norm_rope_vs_plain(an, rp, ref)

    phase("8 the transformer at StarCoder2-3B's full width")
    _, starcoder = transformer_phases(fa, da, an, rp)

    phase("9 LM-expert router, full width, 2 layers (the second slice's "
          "main path)")
    _, sc2_router = lm_router_phase(fa.flash_attention)
    gc.collect()
    torch.cuda.empty_cache()

    phase("10 scan kernel vs plain")
    mamba_lines = mamba_vs_plain(ms, ref)

    phase("11 Falcon-Mamba-7B at its published width")
    _, falcon = falcon_phases(ms, an, rp)

    phase("12 LM-expert router, Falcon-Mamba-7B experts, full width, 2 "
          "layers (the third slice's main path)")
    scan_lines, fm_router = lm_router_phase(ms.mamba_scan,
                                            "falcon_mamba_7b")
    for line in scan_lines:
        if "routes" in line and line["routes"] != {
                "seq": line["kernel_launches"], "chunked": 0}:
            raise AssertionError(
                f"{line['policy']}: the router's 16-token scans took "
                f"{line['routes']}: all should take the seq kernel")

    gc.collect()
    torch.cuda.empty_cache()

    phase("13 Moonlight-16B-A3B at its published width")
    _, _, moon = moonlight_phases(fa, da, an, rp)

    phase("14 Jamba-v0.1 with its MoE, depth cut to whole periods")
    _, jamba = jamba_phases(fa, da, ms, an, rp)

    phase("14c a Jamba2-Mini stage: dropless MoE over 8 held experts "
          "through the grouped kernel")
    moe_line, jamba2 = jamba2_stage_phase(fa, ms, an, rp, mg, ref)

    avail = mem_available_gb()
    layers = 2 if avail >= 40 else 1
    phase(f"15 LM-expert router, Moonlight-16B-A3B experts, full width, "
          f"{layers} layers (this slice's main path)")
    print(json.dumps({"host_mem_available_gb": avail, "layers": layers,
                      "note": "2 layers need 25.4 GB of host memory for "
                              "the seven experts; under 40 GB free the run "
                              "takes 1 layer"}), flush=True)
    _, moon_router = lm_router_phase(
        fa.flash_attention, "moonshot_v1_16b_a3b", layers)
    gc.collect()
    torch.cuda.empty_cache()

    phase("16 Whisper-medium at its published width")
    _, whisper = whisper_phases(fa, da)
    gc.collect()
    torch.cuda.empty_cache()

    # phase 18's dry-run cells run on the host's cores alongside phase 17,
    # which keeps the card busy
    dryrun_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    dryrun = start_dryrun(dryrun_dir)
    memory_trace = start_memory_trace(dryrun_dir)
    try:
        phase("17 training on the card")
        left_gb = torch.cuda.memory_allocated() / 1e9
        print(json.dumps({"allocated_gb_before_training": left_gb}),
              flush=True)
        if left_gb > 4:
            raise AssertionError(f"the earlier phases left {left_gb:.1f} "
                                 "GB allocated on the card")
        training = training_phases()

        phase("18 the dry run: meta DTensors on a fake process group of 512 "
              "ranks (seven cells, each in its own process, started with "
              "phase 17)")
        finish_dryrun(dryrun)

        phase("19 the local mesh on the card: a train step with DTensor "
              "params")
        gc.collect()
        torch.cuda.empty_cache()
        local_mesh_phase()

        phase("20 the dry run's memory against the card: 17b's and 17h's "
              "steps traced on meta tensors (started with phase 18)")
        memory_phase(memory_trace, training)
    finally:
        for proc, _, log, _ in (*dryrun, memory_trace):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(dryrun_dir, ignore_errors=True)

    # each kernel's launches on the main paths: the serving run, the
    # routers, the five whole-model runs (8b, 11b, 13b, 14b, 16b) and the
    # Jamba2-Mini stage's forward (14c), each counted from 0 around its run
    launches = {"decode_attention": decode_launches}
    for counts in (sc2_router, fm_router, moon_router,
                   jamba2["launches_forward"],
                   *(summary[key] for summary in (starcoder, falcon, moon,
                                                  jamba, whisper)
                     for key in ("launches_prefill",
                                 "launches_32_decode_steps"))):
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count

    rep = next(ln for ln in lines if ln["reported"])
    flash_rep = next(ln for ln in flash_lines if ln["reported"])
    mamba_rep = next(ln for ln in mamba_lines if ln["reported"])
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": [
        kernel_entry("decode_attention", DECODE_SOURCE, DECODE_REPLACES,
                     launches["decode_attention"], rep),
        kernel_entry("flash_attention", FLASH_SOURCE, FLASH_REPLACES,
                     launches["flash_attention"], flash_rep),
        kernel_entry("mamba_scan", MAMBA_SOURCE, MAMBA_REPLACES,
                     launches["mamba_scan"], mamba_rep),
        kernel_entry("add_norm", ADD_NORM_SOURCE, NO_TPU_KERNEL,
                     launches["add_norm"], norm_lines[0]),
        kernel_entry("rope", ROPE_SOURCE, NO_TPU_KERNEL, launches["rope"],
                     rope_lines[0]),
        kernel_entry("moe_grouped", MOE_SOURCE, MOE_REPLACES,
                     launches["moe_grouped"], moe_line)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == [LOCAL_MESH_FLAG]:
        sys.exit(local_mesh_step())
    if sys.argv[1:2] == [META_PEAKS_FLAG] and len(sys.argv) == 3:
        sys.exit(meta_train_peaks(sys.argv[2]))
    sys.exit(main())
