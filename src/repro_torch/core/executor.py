"""Inference executors (paper §4.1): queue + shared model pool + exec/load.

An executor owns a request queue (list of same-expert groups) and two
resources: the execution unit and a load channel. The model pool is *shared*
between executors on the same memory domain (the paper's 3 GPU executors on
one 12 GB device): an expert loaded by one executor serves them all. Load of
the next group's expert overlaps execution of the current batch (the paper's
condition (b): "loaded during the processing of a preceding request"). The
transfers themselves ride the memory hierarchy's contended channels — the
shared SSD fan-in plus the executor's device link (``link_group``, its own
PCIe channel in per-device fleets) — so a load's observed latency includes
any queueing behind peers' traffic on exactly those links.
Both the event-driven simulator and the real-JAX backend drive the same
state machine, so switch counts are backend-independent.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.core.coe import CoEModel, Request
from repro_torch.core.expert_manager import ExpertManager
from repro_torch.core.profiler import ArchProfile, DeviceProfile
from repro_torch.core.scheduler import (Group, bump_queue, max_executable_batch,
                                  split_batch)
from repro_torch.memory import DevicePool, MemoryHierarchy
from repro_torch.obs import NULL_TRACER, Tracer


class TrackedQueue(list):
    """Executor queue (list of Groups) with a version stamp: every
    structural mutation bumps ``version`` so cached per-queue aggregates
    (pending work, queued-expert counts) invalidate even when callers —
    work stealing, fault injection, tests — mutate the list directly.
    Group-size changes (requests joining an existing Group, batch splits)
    don't go through list methods; those two call sites call ``bump()``."""

    __slots__ = ("version",)

    def __init__(self, iterable=()):
        super().__init__(iterable)
        self.version = 0

    def bump(self):
        self.version += 1

    def append(self, x):
        self.version += 1
        super().append(x)

    def insert(self, i, x):
        self.version += 1
        super().insert(i, x)

    def pop(self, i=-1):
        self.version += 1
        return super().pop(i)

    def remove(self, x):
        self.version += 1
        super().remove(x)

    def clear(self):
        self.version += 1
        super().clear()

    def extend(self, it):
        self.version += 1
        super().extend(it)

    def __delitem__(self, i):
        self.version += 1
        super().__delitem__(i)

    def __setitem__(self, i, v):
        self.version += 1
        super().__setitem__(i, v)

    def __iadd__(self, other):
        self.version += 1
        return super().__iadd__(other)


@dataclasses.dataclass
class ExecStats:
    switches: int = 0            # expert loads into the device pool (post-init)
    evictions: int = 0
    completed: int = 0
    busy_time: float = 0.0
    load_time: float = 0.0       # total transfer occupancy (incl. overlapped)
    stall_time: float = 0.0      # demand-load time the executor sat idle for
    mgmt_time: float = 0.0       # wall time spent in eviction decisions


class Executor:
    def __init__(self, ex_id: str, device: str, coe: CoEModel,
                 device_profile: DeviceProfile, pool: DevicePool,
                 batch_bytes: int, manager: ExpertManager, engine,
                 prefetch: bool = True, protect_queued: bool = True,
                 hierarchy: Optional[MemoryHierarchy] = None,
                 tracer: Optional[Tracer] = None):
        self.id = ex_id
        self.device = device                      # "tpu"/"gpu" | "host"/"cpu"
        self.coe = coe
        self.device_profile = device_profile
        self.pool = pool                          # SHARED memory-domain pool
        self.batch_bytes = batch_bytes
        self.manager = manager
        self.engine = engine
        self.prefetch = prefetch
        self.protect_queued = protect_queued
        self.hierarchy = hierarchy                # cross-tier prefetch hook
        self.tracer = tracer or NULL_TRACER       # flight recorder (obs)

        pool.users = getattr(pool, "users", [])
        pool.users.append(self)

        self.queue: TrackedQueue = TrackedQueue()
        self.busy_until: float = 0.0
        self.current: Optional[Tuple[str, List[Request], Any]] = None
        self.load_in_flight: Optional[Tuple[str, float]] = None  # (expert, done)
        self.stats = ExecStats()
        self.alive = True
        # token-level decode (PR 9): CoServeSystem wires the shared
        # DecodeRuntime here when decode is on; None otherwise (and every
        # decode branch below is a single attribute check)
        self.decode = None
        # fast-path caches (PR 7): queue-work seconds validated against
        # (queue version, residency epoch); queued-group counts validated
        # against queue version alone. ``use_pending_cache = False`` restores
        # naive per-call recomputation (the retained reference path).
        self.use_pending_cache = True
        self._work_cache: Tuple[int, int, float] = (-1, -1, 0.0)
        self._groups_cache: Tuple[int, Dict[str, int]] = (-1, {})

    # ------------------------------------------------------------------ #
    # profile / latency helpers
    # ------------------------------------------------------------------ #
    def profile(self, arch: str) -> ArchProfile:
        return self.device_profile.arch_profiles[arch]

    @property
    def link_group(self) -> str:
        """The device-link key this executor's loads ride: its pool group
        (one PCIe channel per pool in per-device fleets; ignored in
        shared-link mode)."""
        return self.pool.group

    def load_latency(self, expert_id: str) -> float:
        return self.engine.load_latency(self, expert_id)

    def exec_latency(self, expert_id: str, n: int) -> float:
        return self.engine.exec_latency(self, expert_id, n)

    def max_batch_for(self, expert_id: str) -> int:
        prof = self.profile(self.coe.spec(expert_id).arch)
        return max_executable_batch(prof, self.batch_bytes)

    # ------------------------------------------------------------------ #
    # pending time (paper §4.2: queue total inference-time prediction)
    # ------------------------------------------------------------------ #
    def pending_time(self, now: float) -> float:
        return max(0.0, self.busy_until - now) + self.queue_work()

    def _residency_epoch(self):
        """The shared residency epoch that covers everything ``queue_work``
        reads beyond the queue itself (pool membership for the seen-set,
        peer/host residency inside ``load_latency``) — or None when caching
        would be unsound: no hierarchy, an engine priced off different state
        (RealEngine reads its own host store), or caching disabled."""
        h = self.hierarchy
        if self.use_pending_cache and h is not None \
                and getattr(self.engine, "hierarchy", None) is h:
            return h.epoch
        return None

    def queue_work(self) -> float:
        """Total inference-time prediction of the queue (paper §4.2): per
        group the linear exec model, plus one load per distinct non-resident
        expert. This is the ``now``-independent part of ``pending_time``,
        cached against (queue version, residency epoch) so the scheduler's
        per-arrival makespan argmin is O(executors), not O(executors x
        queue). The recompute below IS the naive loop — summation order is
        preserved, so cached and uncached values are bit-identical."""
        epoch = self._residency_epoch()
        if epoch is not None:
            qv, en, work = self._work_cache
            if qv == self.queue.version and en == epoch.n:
                return work
        total = 0.0
        seen: Set[str] = set(self.pool.resident)
        for g in self.queue:
            prof = self.profile(self.coe.spec(g.expert_id).arch)
            if g.expert_id not in seen:
                total += self.load_latency(g.expert_id)
                seen.add(g.expert_id)
            total += prof.exec_latency(len(g))
        if epoch is not None:
            self._work_cache = (self.queue.version, epoch.n, total)
        return total

    def queued_groups(self) -> Dict[str, int]:
        """Per-expert queued-group counts, rebuilt lazily on queue mutation —
        the scheduler's O(1) ``queued_same`` probe and ``reorder_head``'s
        queued-expert index."""
        qv, counts = self._groups_cache
        if qv == getattr(self.queue, "version", -2):
            return counts
        counts = {}
        for g in self.queue:
            counts[g.expert_id] = counts.get(g.expert_id, 0) + 1
        if isinstance(self.queue, TrackedQueue):
            self._groups_cache = (self.queue.version, counts)
        return counts

    def queued_requests(self) -> int:
        return sum(len(g) for g in self.queue)

    # ------------------------------------------------------------------ #
    # load path (eviction via the dependency-aware manager)
    # ------------------------------------------------------------------ #
    def start_load(self, expert_id: str, now: float,
                   strict: bool = False, demand: bool = False
                   ) -> Optional[float]:
        """Begin transferring an expert; returns completion time or None if it
        cannot start (un-evictable residents or busy load channel). ``strict``
        (prefetch path) refuses to displace experts with queued work;
        ``demand`` marks a load the executor is idle-waiting on (stall)."""
        if self.load_in_flight is not None or expert_id in self.pool:
            return None
        if self.decode is not None:
            # kv_aware: idle requests' KV blocks yield device bytes to the
            # incoming expert before any weight eviction is considered
            self.decode.expert_load_pressure(self, expert_id, now)
        t0 = _time.perf_counter()
        protected: Set[str] = set()
        if self.protect_queued or strict:
            # protect experts referenced by ANY executor sharing this pool —
            # evicting a peer's queued expert ping-pongs loads across streams
            for peer in getattr(self.pool, "users", [self]):
                protected.update(g.expert_id for g in peer.queue)
                if peer.current is not None:
                    protected.add(peer.current[0])
            protected.discard(expert_id)
        if self.hierarchy is not None:
            # cost-aware eviction ranks victims by their *residency-aware*
            # reload price (HOST replicas are cheap to bring back, DISK-only
            # experts on a backlogged link are not) — the same
            # contended-channel cost the scheduler scores assignments with
            def cost_fn(eid, _now=now):
                return self.hierarchy.assignment_cost(
                    eid, _now, group=self.link_group, device=self.device)
        else:
            cost_fn = self.load_latency
        victims = self.manager.ensure_loadable(
            self.pool, expert_id, load_cost_fn=cost_fn,
            protected=protected, strict=strict)
        self.stats.mgmt_time += _time.perf_counter() - t0
        if victims is None:
            if not self.pool.fits(expert_id):
                raise MemoryError(
                    f"expert {expert_id} larger than pool {self.pool.group}")
            return None  # everything evictable is pinned/loading; retry later
        tracer = self.tracer
        for v in victims:
            self.engine.unload(self, v)
            self.stats.evictions += 1
            if tracer.enabled:
                tracer.emit(now, "evict", self.id, v, pool=self.pool.group)
        if tracer.enabled:
            # resolved BEFORE the transfer mutates host/pool state, with the
            # same precedence begin_device_load re-resolves: peer > host > disk
            via = self._load_source(expert_id)
        self.pool.add(expert_id)
        # sim: contended channel latency; real: queued on the transfer thread
        lat = self.engine.load(self, expert_id, now)
        self.pool.loading[expert_id] = now + lat
        self.load_in_flight = (expert_id, now + lat)
        self.stats.switches += 1
        self.stats.load_time += lat
        if demand:
            self.stats.stall_time += lat
        if tracer.enabled:
            tracer.emit(now, "load", self.id, expert_id, dur=lat,
                        demand=demand, via=via, pool=self.pool.group,
                        bytes=self.coe.spec(expert_id).mem_bytes)
        return now + lat

    def _load_source(self, expert_id: str) -> str:
        """Which tier this load will be served from ("peer"|"host"|"disk"),
        mirroring ``MemoryHierarchy.begin_device_load``'s resolution order
        (and ``begin_host_load``'s host-exec short-circuit for CPU
        executors)."""
        h = self.hierarchy
        if h is None or self.device in ("host", "cpu"):
            if h is not None and h.host_exec_enabled and h.in_host(expert_id):
                return "host"          # runs in place from DRAM, no disk leg
            return "disk"
        if h.peer_source(expert_id, self.pool.group) is not None:
            return "peer"
        return "host" if h.in_host(expert_id) else "disk"

    def finish_load(self, expert_id: str):
        assert self.load_in_flight and self.load_in_flight[0] == expert_id
        self.load_in_flight = None
        self.pool.loading.pop(expert_id, None)
        wait = getattr(self.engine, "wait_load", None)
        if wait is not None:            # real backend: join the transfer thread
            wait(self, expert_id)
        self.pool.ready.add(expert_id)

    # ------------------------------------------------------------------ #
    # execution path
    # ------------------------------------------------------------------ #
    def can_execute_head(self) -> bool:
        return bool(self.queue) and self.queue[0].expert_id in self.pool.ready

    def start_next_batch(self, now: float) -> Optional[float]:
        """Pop a batch from the head group and execute; returns finish time."""
        if self.current is not None or not self.can_execute_head():
            return None
        head = self.queue[0]
        eid = head.expert_id
        batch = split_batch(head, self.max_batch_for(eid))
        if not head.requests:
            self.queue.pop(0)
        else:
            bump_queue(self.queue)   # head group shrank in place
        outputs, lat = self.engine.execute(self, eid, batch)
        self.pool.pin(eid)
        self.pool.touch(eid)
        self.current = (eid, batch, outputs)
        self.busy_until = now + lat
        self.stats.busy_time += lat
        if self.tracer.full:
            on = "host" if self.device in ("host", "cpu") else "device"
            self.tracer.emit(now, "exec", self.id, eid, dur=lat,
                             requests=[r.id for r in batch], n=len(batch),
                             on=on)
        if self.hierarchy is not None:
            # dependency-aware cross-tier prefetch: while this expert runs,
            # promote its likely downstream experts disk -> host
            self.hierarchy.on_execute(eid, now)
        return self.busy_until

    def finish_batch(self, now: float) -> Tuple[str, List[Request], Any]:
        eid, batch, outputs = self.current
        self.current = None
        self.pool.unpin(eid)
        self.stats.completed += len(batch)
        for i, r in enumerate(batch):
            r.done_time = now
            r.result = outputs[i] if outputs is not None else None
        return eid, batch, outputs

    # next expert worth prefetching: first queued group whose expert is not
    # resident (the shared pool tracks in-flight loads from peers)
    def prefetch_candidate(self) -> Optional[str]:
        for g in self.queue:
            if g.expert_id not in self.pool:
                return g.expert_id
        return None
