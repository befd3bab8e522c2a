"""CoServe system facade (paper §4.1): offline -> init -> online phases.

``CoServeSystem`` wires the CoE model, offline profiles, executors, the
dependency-aware scheduler and expert manager. ``SystemPolicy`` presets
reproduce the paper's systems:

  CoServe        : makespan assign + arranging + two-stage eviction + overlap
  CoServe None   : FIFO eviction, no arranging, round-robin assign (ablation)
  Samba-CoE      : single executor, FCFS, LRU (tiered DRAM cache on NUMA)
  Samba-CoE FIFO : FIFO eviction variant
  Samba-CoE Par. : N executors, round-robin FCFS, LRU
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.coe import CoEModel, Request
from repro_torch.core.decode import DecodeConfig, DecodeRuntime
from repro_torch.core.engines import SimEngine
from repro_torch.core.executor import Executor
from repro_torch.core.expert_manager import ExpertManager
from repro_torch.core.profiler import DeviceProfile
from repro_torch.core.scheduler import RequestScheduler, SchedulerPolicy
from repro_torch.fleet import PlacementPlan, validate_pool_groups
from repro_torch.memory import MemoryHierarchy, PrefetchConfig, TierSpec
from repro_torch.obs import NULL_TRACER, Tracer


@dataclasses.dataclass(frozen=True)
class SystemPolicy:
    name: str = "coserve"
    assign: str = "makespan"          # makespan | round_robin | single
    arrange: bool = True
    evict: str = "dependency_prob"    # dependency_prob | lru | fifo | prob | cost_benefit
    prefetch: bool = True             # overlap device loads with execution
    host_prefetch: bool = True        # dependency-aware disk->host promotion
    prefetch_trigger: str = "exec"    # exec (upstream starts executing) |
    #                                   queue (upstream joins a queue: wider
    #                                   window, more speculative SSD traffic)
    protect_queued: bool = True       # demand loads evict queue-referenced
    #                                   experts only as a last resort
    host_cache_policy: str = "prob"
    work_stealing: bool = False       # beyond-paper straggler mitigation
    lookahead: int = 0                # beyond-paper dequeue-time window
    host_exec: bool = False           # heterogeneous CPU co-execution:
    #                                   host-DRAM-resident experts run in
    #                                   place on host/CPU executors instead
    #                                   of paying a disk reload (the
    #                                   scheduler prices min(execute-on-host,
    #                                   load-then-execute-on-device))


COSERVE = SystemPolicy()
COSERVE_NONE = SystemPolicy(name="coserve_none", assign="round_robin",
                            arrange=False, evict="fifo", prefetch=True,
                            protect_queued=False)
COSERVE_EM = SystemPolicy(name="coserve_em", assign="round_robin",
                          arrange=False, evict="dependency_prob", prefetch=True)
COSERVE_EM_RA = SystemPolicy(name="coserve_em_ra", assign="round_robin",
                             arrange=True, evict="dependency_prob", prefetch=True)
SAMBA = SystemPolicy(name="samba_coe", assign="single", arrange=False,
                     evict="lru", prefetch=False, host_prefetch=False,
                     protect_queued=False, host_cache_policy="lru")
SAMBA_FIFO = SystemPolicy(name="samba_coe_fifo", assign="single",
                          arrange=False, evict="fifo", prefetch=False,
                          host_prefetch=False, protect_queued=False,
                          host_cache_policy="lru")
SAMBA_PARALLEL = SystemPolicy(name="samba_coe_parallel", assign="round_robin",
                              arrange=False, evict="lru", prefetch=False,
                              host_prefetch=False, protect_queued=False,
                              host_cache_policy="lru")


def nearest_rank(sorted_xs: Sequence[float], q: float) -> float:
    """Nearest-rank quantile: element ceil(q*n) (1-indexed) of sorted data."""
    n = len(sorted_xs)
    return sorted_xs[min(n - 1, max(0, math.ceil(q * n) - 1))]


def latency_percentiles(latencies: Sequence[float]) -> Dict[str, float]:
    """Exact p50/p95/p99 over a finished run (nearest-rank)."""
    if not latencies:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
    xs = sorted(latencies)
    return {"p50": nearest_rank(xs, 0.50), "p95": nearest_rank(xs, 0.95),
            "p99": nearest_rank(xs, 0.99)}


@dataclasses.dataclass
class Metrics:
    completed: int = 0
    switches: int = 0
    evictions: int = 0
    makespan: float = 0.0
    throughput: float = 0.0
    avg_latency: float = 0.0
    p50_latency: float = 0.0
    p95_latency: float = 0.0
    p99_latency: float = 0.0
    stall_time: float = 0.0           # demand-load time executors idled on
    sched_time: float = 0.0           # wall time in scheduling (overhead, Fig.19)
    mgmt_time: float = 0.0            # wall time in expert management
    events_processed: int = 0         # simulator heap events popped
    wall_s: float = 0.0               # wall-clock time of the run loop
    per_executor: Dict[str, Any] = dataclasses.field(default_factory=dict)
    per_tenant: Dict[str, Any] = dataclasses.field(default_factory=dict)
    memory: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #                                 # hierarchy snapshot (channels, prefetch)
    decode: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #                                 # token-level decode snapshot (tokens,
    #                                 # TTFT/token percentiles, KV traffic);
    #                                 # empty when decode is off


@dataclasses.dataclass
class ExecutorSpec:
    device: str                        # "tpu"/"gpu" | "host"/"cpu"
    profile: DeviceProfile
    batch_bytes: int
    pool_group: str = ""               # memory domain; defaults to ``device``


class CoServeSystem:
    def __init__(self, coe: CoEModel, executor_specs: Sequence[ExecutorSpec],
                 pools: Dict[str, int],
                 policy: SystemPolicy = COSERVE, tier: Optional[TierSpec] = None,
                 engine=None, links: str = "shared",
                 placement: Optional[PlacementPlan] = None,
                 replication: int = 0, tracer: Optional[Tracer] = None,
                 decode: Optional[DecodeConfig] = None):
        """``pools`` maps memory-domain name -> expert-pool bytes. Executors
        with the same ``pool_group`` share one ModelPool (one physical
        device's memory), as in the paper's multi-executor single-GPU setup.
        ``links`` picks the host->device channel layout (``shared`` |
        ``per-device``); ``placement`` supplies an explicit expert->pool
        plan (default: ``PlacementPlan.build`` — the paper's round-robin
        sweep plus ``replication`` planned copies of the hottest experts).
        """
        self.coe = coe
        self.policy = policy
        self.tier = tier
        self.tracer = tracer or NULL_TRACER   # flight recorder (repro_torch.obs)
        # spec-level guard: one pool group is one physical device's memory —
        # conflicting device kinds must not share a residency set
        self.pool_devices = validate_pool_groups(executor_specs)
        # the unified tiered-memory subsystem owns host tier, device pools,
        # contended transfer channels and the cross-tier prefetcher
        self.hierarchy = MemoryHierarchy(
            coe, tier, pools, host_policy=policy.host_cache_policy,
            prefetch=PrefetchConfig(enabled=policy.host_prefetch,
                                    trigger=policy.prefetch_trigger),
            links=links,
            link_groups=[g for g in pools
                         if self.pool_devices.get(g) not in ("host", "cpu")])
        self.host_cache = self.hierarchy.host          # seed-compat alias
        self.pools = self.hierarchy.pools
        # channel-leg events (xfer) are emitted where the legs are issued
        self.hierarchy.transfer.tracer = self.tracer
        # heterogeneous CPU co-execution: the hierarchy prices host-resident
        # experts as free-to-run on CPU executors, and engines short-circuit
        # their "load" (off by default — hetero=off costs are bit-identical)
        self.hierarchy.host_exec_enabled = policy.host_exec
        self.engine = engine or SimEngine(coe, tier, hierarchy=self.hierarchy)
        if policy.host_exec and hasattr(self.engine, "host_exec_enabled"):
            self.engine.host_exec_enabled = True
        bind = getattr(self.engine, "bind_topology", None)
        if bind is not None:     # real backend: one transfer thread per link
            bind(self.hierarchy.topology, self.hierarchy)
        self.manager = ExpertManager(coe, policy=policy.evict)
        self.executors: List[Executor] = []
        for i, spec in enumerate(executor_specs):
            group = spec.pool_group or spec.device
            self.hierarchy.register_batch_bytes(group, spec.batch_bytes)
            self.executors.append(Executor(
                ex_id=f"{spec.device}{i}", device=spec.device, coe=coe,
                device_profile=spec.profile, pool=self.pools[group],
                batch_bytes=spec.batch_bytes, manager=self.manager,
                engine=self.engine, prefetch=policy.prefetch,
                protect_queued=policy.protect_queued,
                hierarchy=self.hierarchy, tracer=self.tracer))
        self.scheduler = RequestScheduler(
            self.executors,
            SchedulerPolicy(assign=policy.assign, arrange=policy.arrange,
                            lookahead=policy.lookahead))
        self.scheduler.tracer = self.tracer
        # token-level decode (PR 9): one shared DecodeRuntime drives every
        # executor's continuous batch and owns KV-block residency. None (the
        # default) keeps the stage-level simulation bit-identical.
        self.decode: Optional[DecodeRuntime] = None
        if decode is not None:
            self.decode = DecodeRuntime(decode, self.hierarchy,
                                        tracer=self.tracer,
                                        engine=self.engine)
            self.hierarchy.kv = self.decode
            for ex in self.executors:
                ex.decode = self.decode
        self.sched_time = 0.0
        # observed per-expert load (assignment counts): the online signal
        # placement rebalancing and the "observed" eviction policy use
        # instead of static pre-assessed P(use)
        self.expert_load: Dict[str, int] = {}
        self.manager.observed_load = self.expert_load
        if self.hierarchy.host is not None:
            self.hierarchy.host.observed_load = self.expert_load
        # system initialisation (paper §4.1 steps 1–3) through the explicit
        # plan: round-robin by descending usage probability until pools are
        # full, plus any planned replicas
        self.placement = placement if placement is not None \
            else PlacementPlan.build(coe, pools, replication=replication)
        self.placement.validate()
        self._apply_placement()
        # cachesan: REPRO_CACHE_SANITIZE=1 shadow-validates the
        # epoch-guarded caches on every system built anywhere (the CI
        # equivalence leg) — lazy import, the hook costs one env read
        if os.environ.get("REPRO_CACHE_SANITIZE"):
            from repro_torch.analysis.cachesan import install_from_env
            install_from_env(self)

    # ------------------------------------------------------------------ #
    def _apply_placement(self):
        """Warm the device pools to the plan's layout (init phase: transfers
        are untimed, exactly like the seed's placement loop)."""
        for eid, group in self.placement.layout():
            pool = self.pools.get(group)
            if pool is None:
                continue               # plan built for a pool we don't have
            if eid not in pool and self.coe.spec(eid).mem_bytes \
                    <= pool.free_bytes():
                pool.add(eid)
                pool.ready.add(eid)
                if hasattr(self.engine, "warm_place"):
                    self.engine.warm_place(pool, eid)

    # ------------------------------------------------------------------ #
    def live_executors(self) -> List[Executor]:
        return [e for e in self.executors if e.alive]

    def queue_depth(self) -> int:
        """Total queued requests across live executors — the one definition
        shared by telemetry, admission control and the autoscaler."""
        return sum(e.queued_requests() for e in self.live_executors())

    def assign(self, req: Request, now: float) -> Executor:
        span = self.tracer.open("assign", "scheduler", req.expert_id,
                                hold=True) \
            if self.tracer.wall else None
        t0 = time.perf_counter()
        ex = self.scheduler.assign(req, now)
        self.sched_time += time.perf_counter() - t0
        if span is not None:
            self.tracer.close(span)
        self.expert_load[req.expert_id] = \
            self.expert_load.get(req.expert_id, 0) + 1
        if self.tracer.full:
            # queue-arrival record: timeline reconstruction joins this with
            # exec batch membership to recover per-stage queue waits
            self.tracer.emit(now, "assign", "scheduler", req.expert_id,
                             span=span,
                             request=req.id, executor=ex.id,
                             tenant=req.tenant, parent=req.parent_id)
        # queue-arrival prefetch trigger: the request's expert just joined a
        # queue, so its likely downstream experts can start promoting now
        # (inert unless policy.prefetch_trigger == "queue")
        self.hierarchy.on_enqueue(req.expert_id, now)
        return ex

    def route_followup(self, req: Request, expert_id: str, output) -> Optional[Request]:
        nxt = self.coe.routing.next_expert(req, expert_id, output)
        if nxt is None:
            return None
        # root_arrival_time propagates verbatim: online requests (stamped by
        # the gateway) measure end-to-end across the chain; offline requests
        # keep the seed's per-stage anchor so paper-reproduction latency
        # numbers are unchanged
        return Request(id=-req.id - 1_000_000, expert_id=nxt,
                       arrival_time=req.arrival_time, task_id=req.task_id,
                       data=req.data, parent_id=req.id,
                       tenant=req.tenant, deadline=req.deadline,
                       root_arrival_time=req.root_arrival_time)

    # --- fault tolerance / elasticity ---------------------------------- #
    def fail_executor(self, ex: Executor, now: float) -> List[Request]:
        """Mark dead; return orphaned requests for re-scheduling."""
        ex.alive = False
        orphans: List[Request] = []
        if ex.current is not None:
            eid, batch, _ = ex.current
            orphans.extend(batch)
            ex.current = None
            ex.pool.unpin(eid)
        if ex.load_in_flight is not None:
            # roll the half-finished transfer out of the shared pool —
            # otherwise peers wait forever on an expert that never turns ready
            eid, _ = ex.load_in_flight
            ex.load_in_flight = None
            ex.pool.loading.pop(eid, None)
            if eid in ex.pool and eid not in ex.pool.ready:
                ex.pool.remove(eid)
        for g in ex.queue:
            orphans.extend(g.requests)
        ex.queue.clear()
        if self.decode is not None:
            # mid-decode members lose their KV (it cannot be recovered from
            # a dead executor) and restart from assignment like any orphan
            orphans.extend(self.decode.fail_executor(ex))
        if getattr(ex.pool, "users", None) and ex in ex.pool.users:
            ex.pool.users.remove(ex)
        self.scheduler.executors = self.live_executors()
        # orphans re-enter through assign(): un-count them so the observed
        # per-expert load (rebalance_placement's replica signal) stays one
        # count per served stage — a scale-down must not inflate its victim
        # queue's experts at exactly the moment the signal is consumed
        for r in orphans:
            n = self.expert_load.get(r.expert_id, 0) - 1
            if n > 0:
                self.expert_load[r.expert_id] = n
            else:
                self.expert_load.pop(r.expert_id, None)
        return orphans

    def add_executor(self, spec: ExecutorSpec) -> Executor:
        group = spec.pool_group or spec.device
        if group not in self.pools:
            raise KeyError(f"unknown pool group {group!r}")
        self.pool_devices = validate_pool_groups([spec], self.pool_devices)
        ex = Executor(
            ex_id=f"{spec.device}{len(self.executors)}", device=spec.device,
            coe=self.coe, device_profile=spec.profile,
            pool=self.pools[group], batch_bytes=spec.batch_bytes,
            manager=self.manager, engine=self.engine,
            prefetch=self.policy.prefetch,
            protect_queued=self.policy.protect_queued,
            hierarchy=self.hierarchy, tracer=self.tracer)
        if self.decode is not None:
            ex.decode = self.decode
        self.executors.append(ex)
        self.scheduler.executors = self.live_executors()
        return ex

    # --- fleet placement reconfiguration -------------------------------- #
    def rebalance_placement(self, now: float, max_loads: int = 4
                            ) -> List[Tuple[Executor, str, float]]:
        """Re-plan replication with pools weighted by live executor count
        (a scale event shifted capacity) and experts ranked by *observed*
        per-expert load rather than static P(use), then pull the plan's
        hottest missing experts onto their pools through idle executors'
        contended load path (one in-flight load per pool, bounded by
        ``max_loads`` — a peer fabric turns these into cheap pool -> pool
        copies). Returns (executor, expert, done_time) for each issued load;
        the caller (autoscaler / injection) schedules their LOAD_DONE
        events."""
        weights: Dict[str, float] = {}
        for ex in self.live_executors():
            weights[ex.pool.group] = weights.get(ex.pool.group, 0.0) + 1.0
        self.placement.rebalance(weights,
                                 expert_weights=self.expert_load or None)
        issued: List[Tuple[Executor, str, float]] = []
        for group, pool in self.pools.items():
            if len(issued) >= max_loads:
                break
            idle = [e for e in self.live_executors()
                    if e.pool is pool and e.load_in_flight is None]
            if not idle:
                continue
            carrier = idle[0]
            for eid in self.placement.planned(group):
                if eid in pool:
                    continue
                if self.coe.spec(eid).mem_bytes > pool.free_bytes():
                    continue           # replicas fill free space, never evict
                done = carrier.start_load(eid, now, strict=True)
                if done is not None:
                    issued.append((carrier, eid, done))
                break                  # one in-flight load per pool
        return issued

    # --- beyond-paper: work stealing ------------------------------------ #
    def try_steal(self, thief: Executor, now: float) -> bool:
        """Cost-aware stealing: an idle executor takes a whole group from the
        most-loaded queue only when its own cost (execution + any expert load)
        is smaller than BOTH the time removed from the victim and the idle
        gap — a blind tail-steal un-does the dependency-aware grouping by
        paying a switch the victim would not have paid."""
        if not self.policy.work_stealing or thief.queue:
            return False
        cands = [e for e in self.live_executors()
                 if e is not thief and len(e.queue) >= 2]
        if not cands:
            return False
        victim = max(cands, key=lambda e: e.pending_time(now))
        gap = victim.pending_time(now) - thief.pending_time(now)
        if gap <= 0:
            return False
        best, best_cost = None, None
        for i in range(len(victim.queue) - 1, 0, -1):   # never steal the head
            g = victim.queue[i]
            arch = self.coe.spec(g.expert_id).arch
            cost = thief.profile(arch).exec_latency(len(g))
            if g.expert_id not in thief.pool:
                cost += thief.load_latency(g.expert_id)
            saved = victim.profile(arch).exec_latency(len(g))
            if g.expert_id not in victim.pool:
                saved += victim.load_latency(g.expert_id)
            if cost < saved and cost < gap \
                    and (best_cost is None or cost < best_cost):
                best, best_cost = i, cost
        if best is None:
            return False
        thief.queue.append(victim.queue.pop(best))
        return True

    # ------------------------------------------------------------------ #
    def collect_metrics(self, completed: List[Request], makespan: float) -> Metrics:
        m = Metrics()
        m.completed = len(completed)
        m.switches = sum(e.stats.switches for e in self.executors)
        m.evictions = sum(e.stats.evictions for e in self.executors)
        m.makespan = makespan
        m.throughput = m.completed / makespan if makespan > 0 else 0.0
        lats = [r.done_time - r.e2e_arrival() for r in completed
                if r.done_time is not None]
        m.avg_latency = sum(lats) / len(lats) if lats else 0.0
        pct = latency_percentiles(lats)
        m.p50_latency = pct["p50"]
        m.p95_latency = pct["p95"]
        m.p99_latency = pct["p99"]
        by_tenant: Dict[str, List[float]] = {}
        for r in completed:
            if r.done_time is not None:
                by_tenant.setdefault(r.tenant, []).append(
                    r.done_time - r.e2e_arrival())
        m.per_tenant = {
            t: {"completed": len(ls),
                "avg_latency": sum(ls) / len(ls),
                **latency_percentiles(ls)}
            for t, ls in by_tenant.items()}
        m.stall_time = sum(e.stats.stall_time for e in self.executors)
        m.sched_time = self.sched_time
        m.mgmt_time = sum(e.stats.mgmt_time for e in self.executors)
        m.per_executor = {
            e.id: dataclasses.asdict(e.stats) for e in self.executors}
        m.memory = self.hierarchy.snapshot()
        m.memory["pool_devices"] = dict(self.pool_devices)
        m.memory["placement"] = self.placement.snapshot()
        measured = getattr(self.engine, "measured_load_time", None)
        if measured is not None:      # real backend: worker wall time
            m.memory["real_measured_load_s"] = round(measured, 4)
        if self.decode is not None:
            m.decode = self.decode.metrics_snapshot()
        return m
