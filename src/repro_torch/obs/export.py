"""Chrome trace-event export: flight-recorder events as a Perfetto trace.

Source of truth: the only writer (and validator) of the on-disk trace
artifact — ``Session.save_events``, the ``--trace-events`` CLI flag and the
CI trace smoke all produce/consume exactly this format.

The output is the Chrome trace-event JSON object format
(``{"traceEvents": [...]}``, loadable in Perfetto / ``chrome://tracing``):

  pid 1 "executors"  one thread per executor — ``exec`` batches as complete
                     ("X") slices, demand-load stalls as ``stall:<expert>``
                     slices (an executor is idle while a demand load is in
                     flight, so the two never overlap on a track), ``evict``
                     as instants;
  pid 2 "channels"   one thread per transfer channel (SSD fan-in, per-device
                     PCIe, peer ingress) — ``xfer`` legs as "X" slices named
                     by the expert they move (FIFO channels guarantee
                     non-overlapping slices per track);
  pid 3 "control"    scheduler / gateway / autoscaler decision instants.

Timestamps are sim-seconds scaled to microseconds (the format's unit).
``otherData`` embeds the run's ``Metrics`` aggregates and the tracer's
drop count so ``tools/trace_report.py`` can reconcile the events against
the metrics without a second input file.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

from repro_torch.obs.tracer import Event, Tracer

PID_EXECUTORS = 1
PID_CHANNELS = 2
PID_CONTROL = 3
_PROCESS_NAMES = {PID_EXECUTORS: "executors", PID_CHANNELS: "channels",
                  PID_CONTROL: "control"}
_CONTROL_ACTORS = ("scheduler", "gateway", "autoscaler")

SCHEMA_PHASES = ("X", "i", "M")       # complete, instant, metadata


def _us(t: float) -> float:
    """Sim seconds -> trace microseconds (stable rounding)."""
    return round(t * 1e6, 3)


def _track_map(events: Iterable[Event]) -> Dict[int, List[str]]:
    """pid -> ordered actor (thread) names, deterministic."""
    execs, chans = set(), set()
    for e in events:
        if e.kind in ("exec", "load", "evict"):
            execs.add(e.actor)
        elif e.kind == "xfer":
            chans.add(e.actor)
    return {PID_EXECUTORS: sorted(execs), PID_CHANNELS: sorted(chans),
            PID_CONTROL: list(_CONTROL_ACTORS)}


def chrome_trace(events: Iterable[Event],
                 metadata: Optional[dict] = None) -> dict:
    """Render events as a Chrome trace-event JSON object."""
    events = list(events)
    tracks = _track_map(events)
    tids: Dict[int, Dict[str, int]] = {
        pid: {name: i + 1 for i, name in enumerate(names)}
        for pid, names in tracks.items()}

    out: List[dict] = []
    for pid, name in _PROCESS_NAMES.items():
        out.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                    "args": {"name": name}})
        for actor, tid in tids[pid].items():
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name", "args": {"name": actor}})

    for e in events:
        args = dict(e.attrs)
        if e.kind == "exec":
            out.append({"ph": "X", "pid": PID_EXECUTORS,
                        "tid": tids[PID_EXECUTORS][e.actor], "cat": "exec",
                        "name": e.name, "ts": _us(e.t), "dur": _us(e.dur),
                        "args": args})
        elif e.kind == "load":
            if not args.get("demand"):
                continue               # overlapped prefetch: it never idles
            #                            anyone; its link legs are the xfers
            args["expert"] = e.name
            args["executor"] = e.actor
            out.append({"ph": "X", "pid": PID_EXECUTORS,
                        "tid": tids[PID_EXECUTORS][e.actor], "cat": "load",
                        "name": f"stall:{e.name}", "ts": _us(e.t),
                        "dur": _us(e.dur), "args": args})
        elif e.kind == "xfer":
            args["channel"] = e.actor
            out.append({"ph": "X", "pid": PID_CHANNELS,
                        "tid": tids[PID_CHANNELS][e.actor], "cat": "xfer",
                        "name": e.name, "ts": _us(e.t), "dur": _us(e.dur),
                        "args": args})
        elif e.kind == "evict":
            out.append({"ph": "i", "s": "t", "pid": PID_EXECUTORS,
                        "tid": tids[PID_EXECUTORS][e.actor], "cat": "evict",
                        "name": f"evict:{e.name}", "ts": _us(e.t),
                        "args": args})
        else:                          # control-plane instants
            actor = e.actor if e.actor in tids[PID_CONTROL] else "scheduler"
            out.append({"ph": "i", "s": "t", "pid": PID_CONTROL,
                        "tid": tids[PID_CONTROL][actor], "cat": e.kind,
                        "name": f"{e.kind}:{e.name}", "ts": _us(e.t),
                        "args": args})

    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": metadata or {}}


def validate_chrome_trace(doc: dict) -> None:
    """Structural validation against the Chrome trace-event object format.
    Raises ``ValueError`` listing every problem found."""
    problems: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a Chrome trace: top-level object must have "
                         "a 'traceEvents' array")
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("'traceEvents' must be an array")
    for i, e in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in SCHEMA_PHASES:
            problems.append(f"{where}: ph={ph!r} not in {SCHEMA_PHASES}")
            continue
        for key in ("name", "pid", "tid"):
            if key not in e:
                problems.append(f"{where}: missing {key!r}")
        if ph in ("X", "i"):
            ts = e.get("ts")
            if not isinstance(ts, (int, float)):
                problems.append(f"{where}: ts must be a number, got {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: X events need dur >= 0, "
                                f"got {dur!r}")
        if ph == "i" and e.get("s") not in (None, "t", "p", "g"):
            problems.append(f"{where}: instant scope s={e.get('s')!r}")
        if len(problems) >= 20:
            problems.append("... (further problems suppressed)")
            break
    if problems:
        raise ValueError("invalid Chrome trace: " + "; ".join(problems))


# --------------------------------------------------------------------------- #
# file round trip
# --------------------------------------------------------------------------- #

def trace_metadata(tracer: Tracer, metrics=None) -> dict:
    """The ``otherData`` block: tracer accounting + the Metrics aggregates
    trace_report reconciles against."""
    meta = {"tracer": tracer.snapshot()}
    if metrics is not None:
        meta["metrics"] = {
            "completed": metrics.completed,
            "switches": metrics.switches,
            "evictions": metrics.evictions,
            "makespan_s": metrics.makespan,
            "stall_time_s": metrics.stall_time,
            "avg_latency_s": metrics.avg_latency,
        }
    return meta


def save_events(tracer: Tracer, path: str, metrics=None) -> dict:
    """Export the tracer's ring buffer as a Chrome trace JSON file."""
    doc = chrome_trace(tracer.events, metadata=trace_metadata(tracer, metrics))
    validate_chrome_trace(doc)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return doc


def load_chrome_trace(path: str) -> dict:
    """Read + validate a saved trace file."""
    with open(path) as f:
        doc = json.load(f)
    validate_chrome_trace(doc)
    return doc
