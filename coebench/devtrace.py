"""Reduce a ``torch.profiler`` trace of the window (device activity only)
to what the per-layer metrics read: device busy time (the union of kernel
intervals; copies and memsets are not busy), each kernel name's launches and
device seconds, and the idle gaps between kernels, each put down to what the
host was doing at its middle: the innermost of the benchmark's host-clock
spans around its calls into the program (``forward``, ``load_wait``,
``schedule``, ``execute``; ``harness`` outside them), on the profiler's
time base (``time.time_ns``)."""
from __future__ import annotations

import bisect
import sys
from typing import Dict, List, Tuple

import torch

SPANS = ("forward", "load_wait", "schedule", "execute", "window")
NOT_KERNELS = ("Memcpy", "Memset")


def profiler():
    """The profiler the traced window runs under: the device's activity
    alone (the host's operators would add millions of events to a window);
    on a machine without a card, the host's, so that the path runs."""
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
            else [ProfilerActivity.CPU])
    return profile(activities=acts, record_shapes=False, with_stack=False,
                   profile_memory=False)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(prof, spans: Dict[str, List[tuple]]) -> dict:
    """Busy and window seconds, kernels by name and idle seconds by host
    span, from a finished profiler and the benchmark's spans."""
    from torch.autograd import DeviceType

    kernels: Dict[str, List[float]] = {}
    intervals = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() \
                or name.startswith(NOT_KERNELS):
            continue
        s, d = e.start_ns(), e.duration_ns()
        intervals.append((s, s + d))
        acc = kernels.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += d / 1e9
    spans = {n: spans.get(n, []) for n in SPANS}
    if not spans["window"]:
        raise RuntimeError("no window span was recorded")
    w0, w1 = spans["window"][0]
    busy = _union([(max(s, w0), min(e, w1)) for s, e in intervals
                   if e > w0 and s < w1])
    busy_ns = sum(e - s for s, e in busy)
    idle: Dict[str, float] = {}
    bounds = [w0] + [x for iv in busy for x in iv] + [w1]
    table = {n: sorted(v) for n, v in spans.items() if n != "window"}
    starts = {n: [s for s, _ in v] for n, v in table.items()}
    for gs, ge in zip(bounds[::2], bounds[1::2]):
        if ge <= gs:
            continue
        mid = (gs + ge) // 2
        label = "harness"
        for n in SPANS[:-1]:
            i = bisect.bisect_right(starts[n], mid) - 1
            if i >= 0 and table[n][i][1] >= mid:
                label = n
                break
        idle[label] = idle.get(label, 0.0) + (ge - gs) / 1e9
    outside = sum(1 for s, e in intervals if e <= w0 or s >= w1)
    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9,
            "kernels": kernels, "idle": idle, "outside": outside,
            "first_kernel_s": (min(s for s, _ in intervals) - w0) / 1e9
            if intervals else None}


def kernel_time(tr: dict, key: str) -> Tuple[int, float]:
    """Launches and device seconds of the kernels whose name holds
    ``key``."""
    n, t = 0, 0.0
    for name, (count, sec) in tr["kernels"].items():
        if key in name:
            n += count
            t += sec
    return n, t


def breakdown(tr: dict) -> dict:
    ops = sorted(tr["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(tr["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:120], sec] for name, (_, sec) in ops],
            "idle_gaps": [[name, sec] for name, sec in gaps]}


def roofline_pct(record: dict, kernel: str, key: str):
    """The launches of ``kernel`` (trace names holding ``key``): the sum of
    their bounds from the window's forwards' shapes over their device time,
    in percent; None where the trace holds none of them, or not as many as
    the forwards imply."""
    from coebench import roofline

    tr = record.get("trace")
    want = roofline.launches(record["cfg"], record["forwards"]).get(kernel)
    if not tr or not want:
        return None
    count, secs = kernel_time(tr, key)
    if count != want["launches"] or secs <= 0:
        if count:
            print(f"{kernel}: the trace holds {count} launches, the "
                  f"forwards imply {want['launches']}", file=sys.stderr)
        return None
    return 100.0 * want["bound_s"] / secs
