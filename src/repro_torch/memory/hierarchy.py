"""MemoryHierarchy: one object that owns disk -> host -> device residency.

Source of truth: the only place residency, channel state and transfer
pricing meet — every consumer that asks "what would loading expert X into
pool Y cost *right now*" must ask ``assignment_cost`` here, never re-derive
it.

The seed scattered the hierarchy across four half-coordinated structures
(``HostCache``, ``ModelPool``, ``HostStore``, ``RealEngine.device_params``)
with the load-latency math duplicated in three more places. This facade is
the single owner: tier topology + shared transfer channels + host tier +
device pools + the cross-tier prefetcher, with per-expert residency exposed
as one explicit state machine (``tiers.Residency``).

Engines price and perform transfers through it; the scheduler predicts with
it; the profiler derives per-arch switch costs from it; the autoscaler reads
its device-budget accounting.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.memory.channels import Transfer
from repro_torch.memory.prefetch import CrossTierPrefetcher, PrefetchConfig
from repro_torch.memory.residency import DevicePool, HostTier, StateEpoch
from repro_torch.memory.tiers import Residency, TierSpec, TierTopology
from repro_torch.memory.transfer import TransferEngine

if TYPE_CHECKING:  # pragma: no cover — repro_torch.core imports this package
    from repro_torch.core.coe import CoEModel


class MemoryHierarchy:
    def __init__(self, coe: "CoEModel", tier: Optional[TierSpec],
                 pools: Mapping[str, int],
                 host_policy: str = "prob",
                 prefetch: Optional[PrefetchConfig] = None,
                 links: str = "shared",
                 link_groups: Optional[Sequence[str]] = None):
        """``link_groups`` names the pool groups that get their own PCIe
        channel in per-device mode (the accelerator pools — host/CPU pools
        load over the SSD link only and must not conjure a phantom PCIe
        channel). Defaults to every pool."""
        self.coe = coe
        self.spec = tier if tier is not None else TierSpec(name="default")
        groups = list(pools) if link_groups is None else list(link_groups)
        # the device-pool groups: PCIe links in per-device mode, and the only
        # legal endpoints of peer (device->device) replica copies
        self.link_groups = set(groups)
        self._peer_order = sorted(self.link_groups)   # deterministic sources
        self.topology = TierTopology.from_spec(self.spec, groups=groups,
                                               links=links)
        self.transfer = TransferEngine(self.topology)
        # one residency-transition epoch shared by every tier: pool and host
        # membership changes bump it, so per-expert derived state (settled
        # peer holders here, queue pending-time in the executors) validates
        # with a single integer compare instead of rescanning pools
        self.epoch = StateEpoch()
        # epoch-validated expert -> settled holder pools (in _peer_order);
        # ``cost_cache_enabled`` = False restores the naive O(pools) scans
        # (the retained reference path benchmarks and tests pin against)
        self.cost_cache_enabled = True
        self._holders_cache: Dict[str, Tuple[int, Tuple[str, ...]]] = {}
        # heterogeneous CPU co-execution (policy.host_exec): when on, a
        # host-DRAM-resident expert is *free* to run on a host/CPU executor
        # (no disk reload — it executes in place), so the scheduler's
        # assignment cost prices min(execute_on_host, load_then_execute)
        # across the executor set. Off by default: every cost below is
        # bit-identical to the cache-only host tier.
        self.host_exec_enabled = False
        # token-level decode (PR 9): set to the system's ``DecodeRuntime``
        # when decode is on. Paged KV blocks then occupy device bytes next
        # to expert weights (``DevicePool.kv_bytes``) and a pool whose KV
        # was offloaded owes a PCIe reload before its next decode step —
        # ``assignment_cost`` prices that debt so the scheduler steers new
        # work away from KV-thrashed pools. None keeps every cost below
        # bit-identical to the expert-only hierarchy.
        self.kv = None
        # UMA collapses the middle tier; tier=None (engine-supplied latency
        # models) keeps the seed's no-host-cache behaviour
        self.host: Optional[HostTier] = None
        if tier is not None and not self.spec.unified \
                and self.spec.host_cache_bytes > 0:
            self.host = HostTier(self.spec.host_cache_bytes, coe,
                                 policy=host_policy, epoch=self.epoch)
        self.pools: Dict[str, DevicePool] = {
            g: DevicePool(b, coe, group=g, epoch=self.epoch)
            for g, b in pools.items()}
        self.prefetcher = CrossTierPrefetcher(
            coe, self, prefetch or PrefetchConfig(enabled=False))
        # construction-time activation budget per pool group — the fixed
        # quantity the autoscaler re-divides instead of minting memory
        self.batch_budgets: Dict[str, int] = {}

    # ------------------------------------------------------------------ #
    # residency state machine
    # ------------------------------------------------------------------ #
    def residency(self, expert_id: str) -> Residency:
        """The expert's strongest state across the whole hierarchy."""
        best: Optional[Residency] = None
        rank = {Residency.HOST: 1, Residency.LOADING: 2,
                Residency.DEVICE: 3, Residency.PINNED: 4}
        for pool in self.pools.values():
            st = pool.residency(expert_id)
            if st is not None and (best is None or rank[st] > rank[best]):
                best = st
        if best is not None:
            return best
        if self.host is not None and expert_id in self.host:
            return Residency.HOST
        return Residency.DISK

    def on_any_device(self, expert_id: str) -> bool:
        return any(expert_id in p for p in self.pools.values())

    def in_host(self, expert_id: str) -> bool:
        return self.host is not None and expert_id in self.host

    def peer_source(self, expert_id: str, dst_group: str) -> Optional[str]:
        """The device pool a peer (pool -> pool) copy into ``dst_group``
        could read from: a *sibling* device pool holding a settled copy
        (DEVICE or PINNED — an in-flight LOADING copy cannot be forwarded).
        None when the tier has no peer fabric, the destination is not a
        device pool, or no sibling holds the expert — in which case the
        load falls back to the host-DRAM / disk path.

        The settled-holder list per expert is cached and validated against
        the shared residency epoch, so a scheduler probing 128 executors
        pays the O(pools) scan once per residency transition, not per probe.
        The cached answer is the *first* settled holder that is not the
        destination — exactly what the naive scan returns."""
        if not self.topology.has_peer or dst_group not in self.link_groups:
            return None
        if not self.cost_cache_enabled:
            return self._peer_source_scan(expert_id, dst_group)
        for g in self._settled_holders(expert_id):
            if g != dst_group:
                return g
        return None

    def _peer_source_scan(self, expert_id: str,
                          dst_group: str) -> Optional[str]:
        """The naive per-probe pool scan ``peer_source`` replaced (retained
        as the pinned reference; ``cost_cache_enabled = False`` routes every
        probe through here)."""
        for g in self._peer_order:
            if g == dst_group:
                continue
            pool = self.pools.get(g)
            if pool is None:
                continue
            st = pool.residency(expert_id)
            if st in (Residency.DEVICE, Residency.PINNED):
                return g
        return None

    def _settled_holders(self, expert_id: str) -> Tuple[str, ...]:
        """Epoch-validated tuple of pools holding a settled (DEVICE/PINNED)
        copy, in deterministic ``_peer_order``."""
        hit = self._holders_cache.get(expert_id)
        if hit is not None and hit[0] == self.epoch.n:
            return hit[1]
        holders = []
        for g in self._peer_order:
            pool = self.pools.get(g)
            if pool is None:
                continue
            st = pool.residency(expert_id)
            if st in (Residency.DEVICE, Residency.PINNED):
                holders.append(g)
        out = tuple(holders)
        self._holders_cache[expert_id] = (self.epoch.n, out)
        return out

    # ------------------------------------------------------------------ #
    # latency prediction (uncontended — scheduling decisions)
    # ------------------------------------------------------------------ #
    def predict_device_load(self, expert_id: str, group: str = "") -> float:
        """Uncontended service time of bringing the expert into ``group``'s
        pool from its *current* tier: a sibling device pool over the peer
        fabric when one holds it (and ``group`` identifies a device pool),
        else host DRAM / disk. Callers that don't know the destination pool
        omit ``group`` and get the host/disk formula (seed behaviour)."""
        mem = self.coe.spec(expert_id).mem_bytes
        if group and self.peer_source(expert_id, group) is not None:
            return self.transfer.predict_peer(mem)
        return self.transfer.predict(mem, in_host_cache=self.in_host(expert_id))

    def predict_host_load(self, expert_id: str) -> float:
        return self.transfer.predict_host(self.coe.spec(expert_id).mem_bytes)

    # ------------------------------------------------------------------ #
    # contended transfers (the simulator's actual loads)
    # ------------------------------------------------------------------ #
    def begin_device_load(self, expert_id: str, now: float,
                          group: str = "") -> Transfer:
        """Move an expert into device ``group``'s memory over the contended
        links, populating the host tier on the way through (NUMA). When a
        sibling device pool holds a settled copy and the tier declares a
        peer fabric, the load is a pool -> pool copy on the destination's
        peer ingress link instead of a host-DRAM reload — the cheap replica
        materialization path ``PlacementPlan.rebalance`` counts on."""
        mem = self.coe.spec(expert_id).mem_bytes
        if self.peer_source(expert_id, group) is not None:
            tr = self.transfer.begin_peer_copy(now, mem, group,
                                               label=expert_id)
            # a promotion this copy strands in host DRAM was never consumed
            self.prefetcher.note_device_load(expert_id, served_from_host=False)
            return tr
        in_host = self.in_host(expert_id)
        ready_at = self.host.ready_time(expert_id) if in_host else 0.0
        tr = self.transfer.begin_device_load(now, mem, in_host_cache=in_host,
                                             host_ready_at=ready_at,
                                             group=group, label=expert_id)
        self.prefetcher.note_device_load(expert_id, served_from_host=in_host)
        if self.host is not None:
            if in_host:
                self.host.touch(expert_id)
            else:
                # the disk leg lands the expert in DRAM before the PCIe leg;
                # until then the host copy is in flight, not a settled hit
                self.prefetcher.note_host_evictions(
                    self.host.insert(expert_id, ready_at=tr.host_landed))
        return tr

    def begin_host_load(self, expert_id: str, now: float) -> Transfer:
        """Disk -> host DRAM demand load (CPU executors run from DRAM).
        Under host co-execution a DRAM-resident expert short-circuits: it
        runs in place, so the "load" is a zero-cost transfer that only waits
        out an in-flight promotion's settle gap — no disk traffic."""
        if self.host_exec_enabled and self.host is not None \
                and expert_id in self.host:
            ready = max(now, self.host.ready_time(expert_id))
            self.host.touch(expert_id)
            return Transfer(issued=now, start=now, done=ready)
        tr = self.transfer.begin_host_load(
            now, self.coe.spec(expert_id).mem_bytes, label=expert_id)
        if self.host is not None:
            self.prefetcher.note_host_evictions(
                self.host.insert(expert_id, ready_at=tr.done))
        return tr

    def load_backlog(self, expert_id: str, now: float,
                     group: str = "", device: str = "") -> float:
        """Queueing delay a load into ``group`` issued now would face on its
        first link: the destination's peer ingress link for pool -> pool
        copies, SSD for disk-sourced loads and for host/CPU executors
        (whose loads are disk -> DRAM and never touch a PCIe channel), the
        group's PCIe channel for device-bound host hits."""
        if device not in ("host", "cpu"):
            if self.peer_source(expert_id, group) is not None:
                ch = self.topology.peer_for(group)
                return max(0.0, ch.busy_until - now)
            if self.in_host(expert_id) and not self.spec.unified:
                ch = self.topology.pcie_for(group)
                return max(0.0, ch.busy_until - now)
        ch = self.topology.disk_channel
        return max(0.0, ch.busy_until - now)

    def link_backlog(self, expert_id: str, now: float,
                     group: str = "") -> float:
        """Total queueing delay across every link a device load into
        ``group`` would ride: peer-sourced copies pay the destination's peer
        ingress queue, host hits pay the group's PCIe queue alone,
        disk-sourced loads pay the shared SSD fan-in and then the PCIe leg.
        This is the contended-channel term of the scheduler's residency-aware
        assignment cost — the same channels the TransferEngine charges and
        the prefetcher gates on, so a peer-backlogged replica never looks
        free."""
        if self.peer_source(expert_id, group) is not None:
            return self._backlog(self.topology.peer_for(group), now)
        return self._host_disk_backlog(expert_id, now, group)

    @staticmethod
    def _backlog(ch, now: float) -> float:
        return max(0.0, ch.busy_until - now)

    def _host_disk_backlog(self, expert_id: str, now: float,
                           group: str) -> float:
        """``link_backlog``'s host/disk arm, with the peer check hoisted so
        ``assignment_cost`` resolves the peer source exactly once."""
        if self.spec.unified:
            return self._backlog(self.topology.disk_channel, now)
        if self.in_host(expert_id):
            return self._backlog(self.topology.pcie_for(group), now)
        return self._backlog(self.topology.disk_channel, now) \
            + self._backlog(self.topology.pcie_for(group), now)

    def assignment_cost(self, expert_id: str, now: float, group: str = "",
                        device: str = "") -> float:
        """Residency-aware expert-switch cost of assigning a request to an
        executor on ``group``: the uncontended service time from the tier the
        expert actually occupies (sibling device pool via the peer fabric /
        HOST / DISK) plus the backlog of the specific link(s) the load would
        ride. A disk->host promotion still in flight delays the PCIe leg to
        its SSD-leg completion, so the wait is the larger of the link
        backlog and that settle gap. Replaces the executor-local
        ``load_latency`` guess in ``RequestScheduler.additional_latency``."""
        if device in ("host", "cpu"):
            if self.host_exec_enabled:
                host = self.host
                if host is not None and expert_id in host:
                    # host co-execution: the expert already lives in DRAM —
                    # no transfer at all, only the settle gap of an
                    # in-flight disk->host promotion
                    return max(0.0, host.ready_time(expert_id) - now)
            return self.predict_host_load(expert_id) + self._backlog(
                self.topology.disk_channel, now)
        # peer arm, inlined: this runs once per executor per makespan probe,
        # so the ``peer_source`` indirection (re-checking the fabric and the
        # cache switch per call) is paid 128x per arrival at fleet scale
        topo = self.topology
        if topo.has_peer and group in self.link_groups:
            src = None
            if self.cost_cache_enabled:
                hit = self._holders_cache.get(expert_id)
                holders = hit[1] if hit is not None \
                    and hit[0] == self.epoch.n \
                    else self._settled_holders(expert_id)
                for g in holders:
                    if g != group:
                        src = g
                        break
            else:
                src = self._peer_source_scan(expert_id, group)
            if src is not None:
                mem = self.coe.spec(expert_id).mem_bytes
                ch = topo.peer_for(group)
                cost = self.transfer.predict_peer(mem) \
                    + max(0.0, ch.busy_until - now)
                if self.kv is not None:
                    cost += self.kv.reload_debt(group, now)
                return cost
        cost = self.host_disk_cost(expert_id, now, group)
        if self.kv is not None:
            cost += self.kv.reload_debt(group, now)
        return cost

    def host_disk_cost(self, expert_id: str, now: float,
                       group: str = "") -> float:
        """``assignment_cost``'s host/disk arm alone — what the load would
        cost with no settled sibling copy to peer from. Exposed so the
        placement search's delta scorer can price drop-replica moves
        without re-resolving the (plan-dependent) peer source."""
        mem = self.coe.spec(expert_id).mem_bytes
        wait = self._host_disk_backlog(expert_id, now, group)
        if self.host is not None and self.in_host(expert_id) \
                and not self.spec.unified:
            # begin_device_load starts the PCIe leg at max(now, ready_at)
            wait = max(wait, self.host.ready_time(expert_id) - now)
        return self.transfer.predict(
            mem, in_host_cache=self.in_host(expert_id)) + wait

    def assignment_cost_ref(self, expert_id: str, now: float, group: str = "",
                            device: str = "") -> float:
        """``assignment_cost`` with the naive per-probe pool scan — the
        pinned pre-cache reference. Must return bit-identical values to the
        cached path under any residency churn (tested)."""
        if device in ("host", "cpu"):
            if self.host_exec_enabled:
                host = self.host
                if host is not None and expert_id in host:
                    return max(0.0, host.ready_time(expert_id) - now)
            return self.predict_host_load(expert_id) + self._backlog(
                self.topology.disk_channel, now)
        mem = self.coe.spec(expert_id).mem_bytes
        if self.topology.has_peer and group in self.link_groups \
                and self._peer_source_scan(expert_id, group) is not None:
            cost = self.transfer.predict_peer(mem) \
                + self._backlog(self.topology.peer_for(group), now)
            if self.kv is not None:
                cost += self.kv.reload_debt(group, now)
            return cost
        cost = self.host_disk_cost(expert_id, now, group)
        if self.kv is not None:
            cost += self.kv.reload_debt(group, now)
        return cost

    def speculation_ok(self, expert_id: str, now: float,
                       group: str = "", device: str = "") -> bool:
        """Whether an overlap-prefetch load (queued work issued early) may
        start now: the link's queue must be short enough that demand traffic
        issued a moment later is not pushed far back — shared FIFO channels
        have no priority classes, so issue order is priority. Disk->host
        promotion (pure speculation) uses the stricter ``max_backlog_s``."""
        return self.load_backlog(expert_id, now, group, device) \
            <= self.prefetcher.config.overlap_backlog_s

    # ------------------------------------------------------------------ #
    # hierarchy events
    # ------------------------------------------------------------------ #
    def on_execute(self, expert_id: str, now: float):
        """An expert started executing: chance to prefetch its followers."""
        self.prefetcher.on_execute(expert_id, now)

    def on_enqueue(self, expert_id: str, now: float):
        """A request for this expert joined a queue (group formed but not yet
        head): the queue-arrival prefetch trigger widens the overlap window
        at the cost of more speculative SSD traffic."""
        self.prefetcher.on_enqueue(expert_id, now)

    def note_evicted(self, expert_id: str):
        """A device-pool eviction demotes the expert to host DRAM (NUMA) —
        it is already in DRAM, so this costs no transfer."""
        if self.host is not None:
            self.prefetcher.note_host_evictions(self.host.insert(expert_id))

    # ------------------------------------------------------------------ #
    def register_batch_bytes(self, group: str, batch_bytes: int):
        self.batch_budgets[group] = \
            self.batch_budgets.get(group, 0) + batch_bytes

    def batch_budget(self, group: str) -> int:
        return self.batch_budgets.get(group, 0)

    def residency_counts(self) -> Dict[str, int]:
        counts = {st.value: 0 for st in Residency}
        for eid in self.coe.experts:
            counts[self.residency(eid).value] += 1
        return counts

    def snapshot(self) -> dict:
        out = {"tier": self.spec.name,
               "channels": self.transfer.snapshot(),
               "prefetch": self.prefetcher.snapshot(),
               "residency": self.residency_counts(),
               "pools": {g: p.snapshot() for g, p in self.pools.items()}}
        if self.host is not None:
            out["host"] = self.host.snapshot()
        return out
