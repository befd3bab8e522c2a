"""Flight recorder: typed structured events in a bounded ring buffer.

Source of truth: the only event sink in the serving stack — the simulator
loop, ``RequestScheduler``, ``MemoryHierarchy``/``TransferEngine``,
executors, the admission gate and the autoscaler all emit here, so "what
happened during this run, in order" has exactly one definition.

Design constraints (pinned by tests):

  * zero-cost when disabled — every call site guards with
    ``if tracer.enabled:`` / ``if tracer.full:`` (plain attribute reads; no
    call, no allocation), and the system-wide default is ``NULL_TRACER``,
    so a ``trace: off`` run's metrics are byte-identical to an untraced
    build;
  * bounded — events land in a ``deque(maxlen=capacity)`` ring: a runaway
    stream overwrites the oldest events and counts the drops instead of
    growing without bound (a recorder must never OOM the thing it records);
  * deterministic — events carry *sim time* only, never wall clock, so two
    runs of the same seeded spec produce identical event streams.

Event vocabulary (``kind`` / who emits it / level):

  ``load``    executor begins an expert transfer (demand or overlap
              prefetch) — ``Executor.start_load``; summary
  ``evict``   executor evicts a pool resident to make room; summary
  ``xfer``    one channel leg of a transfer occupies a link (SSD / PCIe /
              peer ingress) — ``TransferEngine``; summary
  ``exec``    executor runs a batch — ``Executor.start_next_batch``; full.
              ``attrs["on"]`` is ``"host"`` when the batch executed in
              place on a CPU executor (heterogeneous co-execution),
              ``"device"`` otherwise
  ``assign``  scheduler placed a request on an executor queue
              (``CoServeSystem.assign``); full
  ``sched``   the scheduler's decision record (policy mode + choice)
              (``RequestScheduler.assign``); full
  ``admit`` / ``shed``  the admission gate's verdict on a fresh arrival
              (online gateway); full / summary
  ``scale``   autoscaler fleet action; summary
  ``decode``  one token-level decode step of an executor's continuous batch
              (``DecodeRuntime``) — ``attrs["requests"]`` is the step's
              membership, ``attrs["kv_wait"]`` the KV-reload portion of
              ``dur``; full
  ``kv``      a KV-block lifecycle transition (alloc / grow / offload /
              reload / spill / release) on a device pool — the bytes side
              of a decode event; the matching channel occupancy rides an
              ``xfer`` event with ``op`` ``kv_offload``/``kv_reload``;
              summary

``actor`` is the track the event belongs to (executor id, channel name,
"scheduler", "gateway", "autoscaler"); ``name`` is the subject (expert id,
tenant, action); ``dur`` > 0 makes it an interval, 0 an instant; free-form
``attrs`` carry the payload (bytes, link leg, request ids, ...).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List

TRACE_LEVELS = ("off", "summary", "full")
DEFAULT_CAPACITY = 262_144        # events; ~60 MB worst case, plenty for the
#                                   bench smokes the CI traces end to end

EVENT_KINDS = ("load", "evict", "xfer", "exec", "assign", "sched",
               "admit", "shed", "scale", "decode", "kv")


@dataclasses.dataclass
class Event:
    """One recorded occurrence, in sim time (seconds)."""
    t: float                      # sim time the event begins
    kind: str                     # one of EVENT_KINDS
    actor: str                    # track: executor / channel / control loop
    name: str                     # subject: expert id, tenant, action, ...
    dur: float = 0.0              # interval length (0 = instant)
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"t": self.t, "kind": self.kind, "actor": self.actor,
                "name": self.name, "dur": self.dur, "attrs": self.attrs}

    @classmethod
    def from_dict(cls, d: dict) -> "Event":
        return cls(t=d["t"], kind=d["kind"], actor=d["actor"],
                   name=d["name"], dur=d.get("dur", 0.0),
                   attrs=dict(d.get("attrs", {})))


class Tracer:
    """The ring-buffer recorder. ``enabled``/``full`` are plain booleans so
    disabled call sites cost one attribute read and nothing else."""

    def __init__(self, level: str = "summary",
                 capacity: int = DEFAULT_CAPACITY):
        if level not in TRACE_LEVELS:
            raise ValueError(f"trace level must be one of {TRACE_LEVELS}, "
                             f"got {level!r}")
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.level = level
        self.enabled = level != "off"
        self.full = level == "full"
        self.capacity = capacity
        self.events: "collections.deque[Event]" = \
            collections.deque(maxlen=capacity)
        self.dropped = 0

    # ------------------------------------------------------------------ #
    def emit(self, t: float, kind: str, actor: str, name: str,
             dur: float = 0.0, **attrs):
        if len(self.events) == self.capacity:
            self.dropped += 1          # the deque evicts the oldest event
        self.events.append(Event(t, kind, actor, name, dur, attrs))

    # ------------------------------------------------------------------ #
    def to_dicts(self) -> List[dict]:
        return [e.to_dict() for e in self.events]

    def by_kind(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for e in self.events:
            counts[e.kind] = counts.get(e.kind, 0) + 1
        return counts

    def snapshot(self) -> dict:
        return {"level": self.level, "capacity": self.capacity,
                "events": len(self.events), "dropped": self.dropped,
                "by_kind": self.by_kind()}


# the system-wide default: every traced object points here unless a real
# Tracer is wired in, so call sites never need a None check
NULL_TRACER = Tracer(level="off", capacity=0)
