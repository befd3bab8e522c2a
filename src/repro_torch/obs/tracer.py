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
    runs of the same seeded spec produce identical event streams (unless
    the wall clock below is on).

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

The wall clock (``Tracer(..., wall=True)``; the port's own, off by
default): every event also carries ``wall_ns``/``wall_dur_ns`` on
``time.time_ns``'s base, the one ``torch.profiler``'s device timestamps use,
an ``id`` and the ``parent`` id of the innermost span open on its thread
when it began, so a real-engine run's events form one tree per
``Simulation.run`` that lays against the card's trace. ``span`` /
``open`` + ``close`` record such intervals; ``exec``, ``assign`` and
``load`` are recorded that way (the wall interval of the real work) and
take their sim-time fields from the later ``emit(..., span=...)``, one
event each. One more kind, ``host``, names spans with no sim-time analogue
(``t`` and ``dur`` stay 0): ``run`` (the event loop), ``evict_decide``,
``transfer`` (a transfer thread's fetch, copies and stream wait),
``load_wait``, ``batch``, ``apply``, ``forward``, ``fetch_out``,
``interpret``, ``complete`` (docs/observability_torch.md has the tree). A
span opened with ``hold=True`` (``assign``, whose interval ``sched_time``
times) holds the instants emitted inside it and records them at its close,
stamped with its start: the recorder's own cost stays out of that timer. A
span's CUDA-event pair (``defer``) is read after a synchronisation the
program already makes (``read_device_times``) or when the events are
collected (``to_dicts``/``snapshot``), never by a synchronisation of its
own.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

TRACE_LEVELS = ("off", "summary", "full")
DEFAULT_CAPACITY = 262_144        # events; ~60 MB worst case, plenty for the
#                                   bench smokes the CI traces end to end

EVENT_KINDS = ("load", "evict", "xfer", "exec", "assign", "sched",
               "admit", "shed", "scale", "decode", "kv", "host")


@dataclasses.dataclass
class Event:
    """One recorded occurrence, in sim time (seconds)."""
    t: float                      # sim time the event begins
    kind: str                     # one of EVENT_KINDS
    actor: str                    # track: executor / channel / control loop
    name: str                     # subject: expert id, tenant, action, ...
    dur: float = 0.0              # interval length (0 = instant)
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # wall clock (a ``wall`` tracer only; None elsewhere)
    wall_ns: Optional[int] = None     # begins, ``time.time_ns`` base
    wall_dur_ns: int = 0
    id: Optional[int] = None
    parent: Optional[int] = None      # id of the enclosing span

    def to_dict(self) -> dict:
        d = {"t": self.t, "kind": self.kind, "actor": self.actor,
             "name": self.name, "dur": self.dur, "attrs": self.attrs}
        if self.wall_ns is not None:
            d.update(wall_ns=self.wall_ns, wall_dur_ns=self.wall_dur_ns,
                     id=self.id, parent=self.parent)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Event":
        return cls(t=d["t"], kind=d["kind"], actor=d["actor"],
                   name=d["name"], dur=d.get("dur", 0.0),
                   attrs=dict(d.get("attrs", {})),
                   wall_ns=d.get("wall_ns"),
                   wall_dur_ns=d.get("wall_dur_ns", 0), id=d.get("id"),
                   parent=d.get("parent"))

    @property
    def wall_end_ns(self) -> int:
        return self.wall_ns + self.wall_dur_ns


class Tracer:
    """The ring-buffer recorder. ``enabled``/``full``/``wall`` are plain
    booleans so disabled call sites cost one attribute read and nothing
    else."""

    def __init__(self, level: str = "summary",
                 capacity: int = DEFAULT_CAPACITY, wall: bool = False):
        if level not in TRACE_LEVELS:
            raise ValueError(f"trace level must be one of {TRACE_LEVELS}, "
                             f"got {level!r}")
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        if wall and level != "full":
            raise ValueError("a wall clock needs the full level")
        self.level = level
        self.enabled = level != "off"
        self.full = level == "full"
        self.wall = wall
        self.capacity = capacity
        self.events: "collections.deque[Event]" = \
            collections.deque(maxlen=capacity)
        self.dropped = 0
        if wall:
            self._ids = itertools.count(1)
            self._lock = threading.Lock()       # transfer threads append too
            self._open = threading.local()      # each thread's open spans
            self._timed: List[tuple] = []       # (event, start, end) unread

    # ------------------------------------------------------------------ #
    def emit(self, t: float, kind: str, actor: str, name: str,
             dur: float = 0.0, span: Optional[Event] = None, **attrs):
        """Record an event at sim time ``t``. On a wall tracer, ``span``
        is the closed span of the same occurrence (``open``/``close``),
        which takes these sim-time fields instead of a second event."""
        if span is not None:
            span.t, span.dur = t, dur
            span.attrs.update(attrs)
            return
        if self.wall:
            held = getattr(self._open, "held", None)
            if held is not None:       # inside a ``hold`` span: no clock
                held[1].append((t, kind, actor, name, dur, attrs))
                return
            self._append(self._begin(kind, actor, name, None, attrs, t, dur))
            return
        if len(self.events) == self.capacity:
            self.dropped += 1          # the deque evicts the oldest event
        self.events.append(Event(t, kind, actor, name, dur, attrs))

    # --- wall clock ------------------------------------------------------ #
    def _stack(self) -> list:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def current(self) -> Optional[Event]:
        """The innermost span open on the calling thread, or None."""
        stack = self._stack()
        return stack[-1] if stack else None

    def _begin(self, kind, actor, name, parent, attrs, t=0.0,
               dur=0.0) -> Event:
        if parent is None:
            cur = self.current()
            parent = cur.id if cur is not None else None
        return Event(t, kind, actor, name, dur, attrs,
                     wall_ns=time.time_ns(), id=next(self._ids),
                     parent=parent)

    def _append(self, ev: Event) -> None:
        with self._lock:
            if len(self.events) == self.capacity:
                self.dropped += 1
            self.events.append(ev)

    def open(self, kind: str, actor: str, name: str,
             parent: Optional[int] = None, hold: bool = False,
             **attrs) -> Event:
        """Begin a wall-clock span on the calling thread; its children
        (spans and events begun on this thread before ``close``) name it
        as their ``parent``, as does a span on another thread that is given
        its ``id``. With ``hold``, the instants emitted inside it are
        recorded at its close, at its start (for a span a program timer
        times: it opens before the timer starts and closes after it
        stops)."""
        ev = self._begin(kind, actor, name, parent, attrs)
        self._stack().append(ev)
        if hold:
            self._open.held = (ev, [])
        return ev

    def close(self, ev: Event, **attrs) -> None:
        """End a span begun by ``open`` and record it, after the instants
        it held."""
        ev.wall_dur_ns = time.time_ns() - ev.wall_ns
        ev.attrs.update(attrs)
        stack = self._stack()
        while stack and stack.pop() is not ev:
            pass                       # spans an exception left open
        held = getattr(self._open, "held", None)
        if held is not None and all(s is not held[0] for s in stack):
            self._open.held = None     # the holder closed (or was left)
            up = held[0]
            for t, kind, actor, name, dur, a in held[1]:
                self._append(Event(t, kind, actor, name, dur, a,
                                   wall_ns=up.wall_ns, id=next(self._ids),
                                   parent=up.id))
        self._append(ev)

    def span(self, kind: str, actor: str, name: str,
             parent: Optional[int] = None, **attrs) -> "_Span":
        """``open``/``close`` around a ``with`` block, which gets the span,
        whose ``id`` children name and whose ``attrs`` it may add to."""
        return _Span(self, (kind, actor, name, parent, attrs))

    def defer(self, ev: Event, start, end, counts=None) -> None:
        """Attach a recorded CUDA event pair to ``ev``: read later into
        ``attrs["device_us"]`` by ``read_device_times``, with ``counts``
        (name -> a host tensor of one element that a copy enqueued before
        ``end`` fills) into ``attrs[name]``."""
        self._timed.append((ev, start, end, counts or {}))

    def read_device_times(self, wait: bool = False) -> None:
        """Read the deferred CUDA event pairs whose end has been reached
        (all of them, waiting, with ``wait``)."""
        if not self.wall or not self._timed:
            return
        left = []
        for item in self._timed:
            ev, start, end, counts = item
            if wait:
                end.synchronize()
            elif not end.query():
                left.append(item)
                continue
            ev.attrs["device_us"] = 1e3 * start.elapsed_time(end)
            ev.attrs.update({k: int(v) for k, v in counts.items()})
        self._timed = left

    # ------------------------------------------------------------------ #
    def to_dicts(self) -> List[dict]:
        self.read_device_times(wait=True)
        return [e.to_dict() for e in self.events]

    def by_kind(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for e in self.events:
            counts[e.kind] = counts.get(e.kind, 0) + 1
        return counts

    def snapshot(self) -> dict:
        self.read_device_times(wait=True)
        return {"level": self.level, "capacity": self.capacity,
                "events": len(self.events), "dropped": self.dropped,
                "by_kind": self.by_kind()}


class _Span:
    """``Tracer.span``'s context (a class: a generator-based context
    manager costs as much again as the span)."""
    __slots__ = ("tracer", "args", "ev")

    def __init__(self, tracer: Tracer, args: tuple):
        self.tracer, self.args = tracer, args

    def __enter__(self) -> Event:
        kind, actor, name, parent, attrs = self.args
        self.ev = self.tracer.open(kind, actor, name, parent, **attrs)
        return self.ev

    def __exit__(self, *exc) -> None:
        self.tracer.close(self.ev)


# the system-wide default: every traced object points here unless a real
# Tracer is wired in, so call sites never need a None check
NULL_TRACER = Tracer(level="off", capacity=0)

# the tracer the model layer records into (``models.transformer.forward``
# has no system to ask): the real engine makes its executor's current on
# its own thread for the length of an ``apply``; NULL_TRACER elsewhere
_ACTIVE = threading.local()


def active() -> Tracer:
    return getattr(_ACTIVE, "tracer", NULL_TRACER)


@contextmanager
def activated(tracer: Tracer):
    prev = active()
    _ACTIVE.tracer = tracer
    try:
        yield
    finally:
        _ACTIVE.tracer = prev
