"""Event-driven serving simulator (virtual clock).

Drives the CoServeSystem state machine over an arrival stream: ARRIVAL events
run the dependency-aware scheduler; executors interleave LOAD_DONE/EXEC_DONE
events with single-load-channel overlap (prefetch). Chained experts (routing
follow-ups) re-enter as arrivals at completion time. Also supports failure /
elastic-scaling injections for the fault-tolerance tests.

Online extensions (repro_torch.serve): arrivals can come from a lazy *source*
generator instead of a pre-materialized list (one pending SOURCE event at a
time, so unbounded streams cost O(1) heap space), TICK events drive periodic
telemetry/control callbacks, and hooks observe admissions and completions:

  ``admission(sim, req) -> bool``  gate on SOURCE arrivals (False = shed);
  ``on_complete(sim, req, now)``   every finished chain-terminal request;
  ``on_stage(sim, req, expert_id, now)``  every finished batch member,
  including intermediate chain stages (per-expert telemetry).
"""
from __future__ import annotations

import heapq
import itertools
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, \
    Sequence, Tuple

from repro_torch.core.coe import Request
from repro_torch.core.executor import Executor
from repro_torch.core.serving import CoServeSystem, Metrics

ARRIVAL, EXEC_DONE, LOAD_DONE, INJECT, SOURCE, TICK, DECODE = range(7)


class Simulation:
    def __init__(self, system: CoServeSystem):
        self.system = system
        # token-level decode (PR 9): the system's DecodeRuntime, or None for
        # stage-level simulation (every decode branch below degrades to one
        # ``is None`` check so decode=off stays bit-identical)
        self.decode = getattr(system, "decode", None)
        self.heap: List[Tuple[float, int, int, Any]] = []
        self._seq = itertools.count()
        self.completed: List[Request] = []
        self.now = 0.0
        # --- online hooks (all optional; None = offline behaviour) ------ #
        self._source: Optional[Iterator[Request]] = None
        self.admission: Optional[Callable[["Simulation", Request], bool]] = None
        self.on_complete: Optional[Callable[["Simulation", Request, float],
                                            None]] = None
        self.on_stage: Optional[Callable[["Simulation", Request, str, float],
                                         None]] = None
        self.shed = 0     # count only: retaining Request objects would grow
        #                   without bound on long overloaded streams
        self._work_events = 0     # non-TICK events in the heap: ticks stop
        #                           rescheduling once only ticks remain

    # ------------------------------------------------------------------ #
    def push(self, t: float, kind: int, payload: Any):
        if kind != TICK:
            self._work_events += 1
        heapq.heappush(self.heap, (t, next(self._seq), kind, payload))

    def submit(self, requests: Sequence[Request]):
        for r in requests:
            self.push(r.arrival_time, ARRIVAL, r)

    def inject(self, t: float, fn: Callable[["Simulation"], None]):
        """Schedule a fault/elasticity injection at time t."""
        self.push(t, INJECT, fn)

    # ------------------------------------------------------------------ #
    # online arrival source + periodic ticks
    # ------------------------------------------------------------------ #
    def set_source(self, requests: Iterable[Request]):
        """Feed arrivals lazily from a generator of Requests (monotone
        ``arrival_time``). Only the next arrival is ever materialized."""
        self._source = iter(requests)
        self._pull_source()

    def _pull_source(self):
        if self._source is None:
            return
        try:
            req = next(self._source)
        except StopIteration:
            self._source = None
            return
        self.push(req.arrival_time, SOURCE, req)

    def add_ticker(self, interval: float,
                   fn: Callable[["Simulation", float], None],
                   start: Optional[float] = None):
        """Call ``fn(sim, now)`` every ``interval`` sim-seconds while work
        remains (ticks never keep an otherwise-drained simulation alive)."""
        if interval <= 0.0:
            raise ValueError(f"ticker interval must be positive, "
                             f"got {interval}")  # 0 would re-arm at the same
        #                                          time and stall the clock
        t0 = self.now + interval if start is None else start
        self.push(t0, TICK, (interval, fn))

    # ------------------------------------------------------------------ #
    def run(self) -> Metrics:
        sys = self.system
        tracer = sys.tracer
        t0 = time.perf_counter()
        n_events = 0
        # wall clock: the loop's span, the root of this run's tree
        span = tracer.open("host", "loop", "run") if tracer.wall else None
        while self.heap:
            t, _, kind, payload = heapq.heappop(self.heap)
            self.now = t
            n_events += 1
            if kind != TICK:
                self._work_events -= 1
            if kind == ARRIVAL:
                ex = sys.assign(payload, t)
                self.kick(ex, t)
            elif kind == SOURCE:
                req = payload
                if self.admission is None or self.admission(self, req):
                    ex = sys.assign(req, t)
                    self.kick(ex, t)
                else:
                    self.shed += 1
                self._pull_source()
            elif kind == TICK:
                interval, fn = payload
                fn(self, t)
                if self._work_events > 0 or self._source is not None:
                    self.push(t + interval, TICK, (interval, fn))
            elif kind == LOAD_DONE:
                ex, eid = payload
                if not ex.alive:
                    continue
                ex.finish_load(eid)
                # the pool is shared: peers waiting on this expert wake too
                # (pool.users is exactly the executors sharing the pool, in
                # construction order — no fleet-wide scan; kick() skips dead)
                for peer in list(ex.pool.users):
                    self.kick(peer, t)
            elif kind == EXEC_DONE:
                ex = payload
                if not ex.alive or ex.current is None:
                    continue
                eid, batch, outputs = ex.finish_batch(t)
                for i, req in enumerate(batch):
                    done = tracer.open("host", "loop", "complete",
                                       request=req.id) if tracer.wall \
                        else None
                    out = outputs[i] if outputs else None
                    if self.on_stage is not None:
                        self.on_stage(self, req, eid, t)
                    follow = sys.route_followup(req, eid, out)
                    if follow is None:
                        if self.decode is not None:
                            # terminal stage = prefill: the request joins the
                            # executor's continuous decode batch instead of
                            # completing; it finishes at its last token
                            self.decode.admit(ex, req, t)
                        else:
                            self.completed.append(req)
                            if self.on_complete is not None:
                                self.on_complete(self, req, t)
                    else:
                        follow.arrival_time = t
                        self.push(t, ARRIVAL, follow)
                    if done is not None:
                        tracer.close(done)
                self.kick(ex, t)
                # a finished batch unpins its expert: pool-sharing peers whose
                # pending load was blocked on that pin can now proceed
                for peer in list(ex.pool.users):
                    if peer is not ex:
                        self.kick(peer, t)
                # idle peers may steal from the longest queue (try_steal is a
                # guaranteed no-op with stealing off — skip the fleet scan)
                if sys.policy.work_stealing:
                    for peer in sys.live_executors():
                        if peer is not ex and not peer.queue \
                                and peer.current is None:
                            if sys.try_steal(peer, t):
                                self.kick(peer, t)
            elif kind == DECODE:
                ex = payload
                if not ex.alive:
                    continue   # fail_executor already dropped its members
                for req in self.decode.finish_step(ex, t):
                    req.done_time = t
                    self.completed.append(req)
                    if self.on_complete is not None:
                        self.on_complete(self, req, t)
                self.kick(ex, t)
                # KV offload/release may have freed pool bytes peers' loads
                # were blocked on
                for peer in list(ex.pool.users):
                    if peer is not ex:
                        self.kick(peer, t)
            else:  # INJECT
                payload(self)
        if span is not None:
            tracer.close(span, events=n_events)
        makespan = max((r.done_time or 0.0) for r in self.completed) \
            if self.completed else 0.0
        m = sys.collect_metrics(self.completed, makespan)
        m.events_processed = n_events
        m.wall_s = time.perf_counter() - t0
        return m

    # ------------------------------------------------------------------ #
    def kick(self, ex: Executor, now: float):
        """Advance one executor: start loads and/or the next batch."""
        if not ex.alive:
            return
        self.system.scheduler.reorder_head(ex, now)
        dec = self.decode
        # start executing if the head group's expert is ready (with decode
        # on, prefill is preferred over the next decode step while the
        # continuous batch has room; a full batch or an unready head lets
        # the decode loop run — steps overlap in-flight demand loads)
        if ex.current is None and (dec is None or not dec.stepping(ex)):
            if not ex.queue and self.system.try_steal(ex, now):
                pass
            done = None
            if dec is None or dec.has_room(ex):
                done = ex.start_next_batch(now)
            if done is not None:
                self.push(done, EXEC_DONE, ex)
            else:
                if ex.queue and ex.load_in_flight is None:
                    head = ex.queue[0].expert_id
                    if head not in ex.pool:
                        # demand load: the executor is idle until it lands
                        t_done = ex.start_load(head, now, demand=True)
                        if t_done is not None:
                            self.push(t_done, LOAD_DONE, (ex, head))
                if dec is not None:
                    t_step = dec.start_step(ex, now)
                    if t_step is not None:
                        ex.busy_until = t_step
                        self.push(t_step, DECODE, ex)
        # overlap: prefetch the next missing expert while executing — strict
        # mode never displaces experts that still have queued groups, and a
        # long shared-channel backlog defers the speculation so it cannot
        # queue ahead of peers' imminent demand loads (retried on next kick)
        if ex.prefetch and ex.load_in_flight is None \
                and (ex.current is not None
                     or (dec is not None and dec.stepping(ex))):
            cand = ex.prefetch_candidate()
            if cand is not None and (ex.hierarchy is None
                                     or ex.hierarchy.speculation_ok(
                                         cand, now, ex.link_group,
                                         ex.device)):
                t_done = ex.start_load(cand, now, strict=True)
                if t_done is not None:
                    self.push(t_done, LOAD_DONE, (ex, cand))

    # ------------------------------------------------------------------ #
    def fail_executor_at(self, t: float, index: int):
        def _fail(sim: "Simulation"):
            sys = sim.system
            ex = sys.executors[index]
            if not ex.alive:
                return
            orphans = sys.fail_executor(ex, sim.now)
            for r in orphans:   # at-most-once re-queue of in-flight work
                sim.push(sim.now, ARRIVAL, r)
            # peers may have been waiting on the dead executor's load channel
            for peer in sys.live_executors():
                sim.kick(peer, sim.now)
        self.inject(t, _fail)

    def add_executor_at(self, t: float, spec):
        def _add(sim: "Simulation"):
            sim.system.add_executor(spec)
        self.inject(t, _add)


def run_real(system: CoServeSystem, requests: Sequence[Request]) -> Metrics:
    """Drive the same state machine with the RealEngine in wall-clock time.

    Arrivals are replayed in order (timestamps compressed); executors are
    drained cooperatively in one process. Switch counts match the simulator
    for identical scheduling decisions.
    """
    import time
    t0 = time.perf_counter()
    sim = Simulation(system)
    now = 0.0
    for r in requests:
        r.arrival_time = now
        sim.push(now, ARRIVAL, r)
    metrics = sim.run()
    metrics.makespan = time.perf_counter() - t0
    metrics.throughput = metrics.completed / metrics.makespan \
        if metrics.makespan > 0 else 0.0
    return metrics
