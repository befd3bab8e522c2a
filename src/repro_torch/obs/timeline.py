"""Per-request timelines: decompose end-to-end latency from trace events.

Source of truth: the only join of the flight recorder's event streams into
a per-request view — where each request's end-to-end latency went, stage by
stage, split into

  queue_wait        time on an executor queue not covered below (includes
                    waiting behind other experts' batches and on overlapped
                    prefetch loads, which stall no one by construction)
  switch_load_wait  time idle-waiting on a demand load from host DRAM/disk
  peer_copy_wait    time idle-waiting on a demand pool -> pool replica copy
  exec              the stage's own batch execution

and, for runs with token-level decode on (PR 9), three more per-chain
components after the terminal stage's prefill:

  decode_wait       time between prefill completion / consecutive decode
                    steps spent waiting for a step boundary (continuous
                    batching admits joiners at step starts only)
  kv_reload_wait    the KV-reload portion of the chain's decode steps
                    (offloaded blocks riding the PCIe link back)
  decode_exec       the steps' compute time itself

Needs a *full*-level trace: stages are reconstructed by joining ``assign``
events (arrival on a queue, chain linkage via ``parent``) with ``exec``
events (batch membership) and demand ``load`` events (stall intervals,
split by ``via``). The components sum exactly to ``end - arrival`` per
stage — queue_wait is defined as the remainder — and chained stages are
contiguous (a follow-up's arrival is its parent stage's completion), so a
chain's stage totals sum to its end-to-end latency. Reconciliation against
``Metrics`` (pinned by tests): terminal-stage totals average to
``Metrics.avg_latency`` for offline runs, whose latency anchor is
per-stage (see ``CoServeSystem.route_followup``).

On a wall-clock trace (``Tracer(..., wall=True)``, the port's real engine),
``stage_records(events, clock="wall")`` makes the same split on the wall
clock, in whole nanoseconds, so it sums exactly: arrival is the
``assign`` span's start, the stage runs over the ``exec`` span (the
engine's whole execution), and the load wait is the ``host/load_wait``
spans of the stage's executor and expert inside its queue time, split by
the ``via`` of the ``load`` each waited on. ``self_times`` and
``idle_by_span`` read the same spans: each span's time outside its
children, and the card's idle gaps put down to the innermost span at their
middle.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

from repro_torch.obs.tracer import Event


@dataclasses.dataclass
class Stage:
    """One executed stage of one request."""
    request: int
    root: int                     # root request id of the chain
    expert: str
    executor: str
    arrival: float                # assign time on the executor queue
    start: float                  # batch execution start
    end: float                    # batch execution end
    queue_wait: float
    switch_load_wait: float
    peer_copy_wait: float
    exec: float
    terminal: bool = False        # no follow-up stage observed

    @property
    def total(self) -> float:
        return self.end - self.arrival

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _clip(lo: float, hi: float, a: float, b: float) -> float:
    """Length of [a, b] ∩ [lo, hi]."""
    return max(0.0, min(hi, b) - max(lo, a))


def stage_records(events: Iterable[Event],
                  clock: str = "sim") -> List[Stage]:
    """Join assign / exec / demand-load events into per-stage records
    (``clock="wall"``: on the wall clock, in whole nanoseconds)."""
    if clock == "wall":
        events = _on_wall_clock(events)
    elif clock != "sim":
        raise ValueError(f"clock must be 'sim' or 'wall', got {clock!r}")
    assigns: Dict[int, List[dict]] = {}
    parents: Dict[int, Optional[int]] = {}
    loads: Dict[tuple, List[tuple]] = {}     # (executor, expert) -> intervals
    execs: List[Event] = []
    for e in events:
        if e.kind == "assign":
            rid = e.attrs["request"]
            assigns.setdefault(rid, []).append(
                {"t": e.t, "expert": e.name, "executor": e.attrs["executor"]})
            parents[rid] = e.attrs.get("parent")
        elif e.kind == "exec":
            execs.append(e)
        elif e.kind == "load" and e.attrs.get("demand"):
            loads.setdefault((e.actor, e.name), []).append(
                (e.t, e.t + e.dur, e.attrs.get("via", "disk")))

    def root_of(rid: int) -> int:
        seen = set()
        while parents.get(rid) is not None and rid not in seen:
            seen.add(rid)
            rid = parents[rid]
        return rid

    has_child = {p for p in parents.values() if p is not None}
    stages: List[Stage] = []
    for ev in execs:
        t_s, t_e = ev.t, ev.t + ev.dur
        for rid in ev.attrs.get("requests", ()):
            cands = [a for a in assigns.get(rid, ()) if a["t"] <= t_s + 1e-12]
            if not cands:
                continue               # assign fell off the ring buffer
            a = max(cands, key=lambda x: x["t"])
            switch = peer = 0.0
            for lo, hi, via in loads.get((ev.actor, ev.name), ()):
                part = _clip(a["t"], t_s, lo, hi)
                if via == "peer":
                    peer += part
                else:
                    switch += part
            stages.append(Stage(
                request=rid, root=root_of(rid), expert=ev.name,
                executor=ev.actor, arrival=a["t"], start=t_s, end=t_e,
                queue_wait=(t_s - a["t"]) - switch - peer,
                switch_load_wait=switch, peer_copy_wait=peer,
                exec=ev.dur, terminal=rid not in has_child))
    return stages


def _on_wall_clock(events: Iterable[Event]) -> List[Event]:
    """The events ``stage_records`` joins, timed on the wall clock in
    nanoseconds: the ``assign`` and ``exec`` spans, and each
    ``host/load_wait`` span as a demand load of its executor and expert,
    with the ``via`` of the load it waited on."""
    events = [e for e in events if e.wall_ns is not None]
    via = {e.id: e.attrs.get("via", "disk") for e in events
           if e.kind == "load"}
    out = []
    for e in events:
        if e.kind in ("assign", "exec"):
            out.append(dataclasses.replace(e, t=e.wall_ns, dur=e.wall_dur_ns))
        elif e.kind == "host" and e.name == "load_wait":
            out.append(Event(e.wall_ns, "load", e.actor, e.attrs["expert"],
                             e.wall_dur_ns,
                             {"demand": True,
                              "via": via.get(e.attrs["load"], "disk")}))
    return out


# spans on a thread other than their parent's: they overlap the serving
# thread's work instead of taking part of it
_OTHER_THREAD = ("transfer",)


def _label(e: Event) -> str:
    return e.name if e.kind == "host" else e.kind


def _serving_spans(events: Iterable[Event]) -> List[Event]:
    return [e for e in events if e.wall_ns is not None and e.wall_dur_ns
            and e.name not in _OTHER_THREAD]


def self_times(events: Iterable[Event]) -> Dict[str, int]:
    """Wall nanoseconds of the serving thread's spans (``host`` spans by
    name, others by kind) outside their child spans, summed over the
    trace."""
    spans = _serving_spans(events)
    out: Dict[str, int] = {}
    for e in spans:
        out[_label(e)] = out.get(_label(e), 0) + e.wall_dur_ns
    ids = {e.id: e for e in spans}
    for e in spans:
        up = ids.get(e.parent)
        if up is not None:
            out[_label(up)] -= e.wall_dur_ns
    return out


def idle_by_span(events: Iterable[Event], busy: List[tuple], start: int,
                 end: int) -> Dict[str, int]:
    """The gaps in ``[start, end)`` between the sorted, disjoint ``busy``
    intervals (the card's kernels, ns on the wall clock's base), in
    nanoseconds by the innermost span open at each gap's middle, or
    ``"outside"`` where none is. Only the serving thread's spans, which
    nest, name a gap: a transfer thread's span does not, as the host is
    not waiting in it."""
    spans = sorted(_serving_spans(events),
                   key=lambda e: (e.wall_ns, -e.wall_dur_ns))
    bounds = [start] + [x for iv in busy for x in iv] + [end]
    out: Dict[str, int] = {}
    stack: List[Event] = []
    i = 0
    for gs, ge in zip(bounds[::2], bounds[1::2]):
        if ge <= gs:
            continue
        mid = (gs + ge) // 2
        while i < len(spans) and spans[i].wall_ns <= mid:
            while stack and stack[-1].wall_end_ns <= spans[i].wall_ns:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].wall_end_ns <= mid:
            stack.pop()
        label = _label(stack[-1]) if stack else "outside"
        out[label] = out.get(label, 0) + (ge - gs)
    return out


def decode_spans(events: Iterable[Event]) -> Dict[int, dict]:
    """Per-request decode summary from ``decode`` step events: every step a
    request is a member of counts fully toward its span (the whole batch
    advances together). Empty for stage-level runs."""
    spans: Dict[int, dict] = {}
    for e in events:
        if e.kind != "decode":
            continue
        for rid in e.attrs.get("requests", ()):
            sp = spans.setdefault(
                rid, {"start": e.t, "end": e.t, "dur": 0.0, "kv": 0.0,
                      "steps": 0})
            sp["start"] = min(sp["start"], e.t)
            sp["end"] = max(sp["end"], e.t + e.dur)
            sp["dur"] += e.dur
            sp["kv"] += e.attrs.get("kv_wait", 0.0)
            sp["steps"] += 1
    return spans


def request_timelines(events: Iterable[Event]) -> Dict[int, dict]:
    """Chain view: root request id -> ordered stages + latency breakdown.

    ``e2e`` spans the whole chain (root arrival to terminal completion —
    the online anchor); ``last_stage`` is the terminal stage's own total
    (the offline anchor). Both are sums of the stage components, so the
    decomposition is exact by construction.
    """
    events = list(events)
    spans = decode_spans(events)
    by_root: Dict[int, List[Stage]] = {}
    for s in stage_records(events):
        by_root.setdefault(s.root, []).append(s)
    out: Dict[int, dict] = {}
    for root, stages in by_root.items():
        stages.sort(key=lambda s: s.arrival)
        last = stages[-1]
        rec = {
            "stages": [s.to_dict() for s in stages],
            "queue_wait": sum(s.queue_wait for s in stages),
            "switch_load_wait": sum(s.switch_load_wait for s in stages),
            "peer_copy_wait": sum(s.peer_copy_wait for s in stages),
            "exec": sum(s.exec for s in stages),
            "decode_wait": 0.0,
            "kv_reload_wait": 0.0,
            "decode_exec": 0.0,
            "e2e": last.end - stages[0].arrival,
            "last_stage": last.total,
            "complete": last.terminal,
        }
        sp = spans.get(last.request)
        if sp is not None:
            # the terminal stage's prefill is followed by its decode span:
            # the chain now ends at its last token. decode_wait is defined
            # as the remainder (step-boundary gaps), so the decomposition
            # stays exact by construction.
            rec["kv_reload_wait"] = sp["kv"]
            rec["decode_exec"] = sp["dur"] - sp["kv"]
            rec["decode_wait"] = (sp["end"] - last.end) - sp["dur"]
            rec["e2e"] = sp["end"] - stages[0].arrival
            rec["last_stage"] = last.total + (sp["end"] - last.end)
        out[root] = rec
    return out


def reconcile(events: Iterable[Event], metrics) -> dict:
    """Compare the event-derived view against the run's ``Metrics``:
    terminal-stage count/mean latency (offline anchor) and summed demand
    stall vs ``Metrics.stall_time``. Returns the deltas; callers decide
    tolerance (tests pin 1e-6 on latency, trace_report pins 1% on stall)."""
    events = list(events)
    stages = stage_records(events)
    spans = decode_spans(events)
    terminals = [s for s in stages if s.terminal]

    def _total(s: Stage) -> float:
        # with decode on, a request finishes at its last token, not at
        # prefill completion — extend the terminal stage by its decode span
        sp = spans.get(s.request)
        return s.total + (sp["end"] - s.end if sp is not None else 0.0)

    mean = sum(_total(s) for s in terminals) / len(terminals) \
        if terminals else 0.0
    # stall from the load events themselves (one per demand load, exactly
    # what ExecStats accumulates) — the per-stage clipped waits count a
    # shared load once per batch member, deliberately, and would overcount
    stall = sum(e.dur for e in events
                if e.kind == "load" and e.attrs.get("demand"))
    return {
        "completed_events": len(terminals),
        "completed_metrics": metrics.completed,
        "avg_latency_events": mean,
        "avg_latency_metrics": metrics.avg_latency,
        "avg_latency_delta": mean - metrics.avg_latency,
        "stall_events_s": stall,
        "stall_metrics_s": metrics.stall_time,
    }
