"""Per-tier residency: the device pool and the host-DRAM tier.

Source of truth: the only record of which experts occupy which tier's bytes
(capacity accounting, pin counts, in-flight markers) — ``MemoryHierarchy``
aggregates these per-tier views into the global ``Residency`` answer.

Both tiers track the same explicit per-expert state machine
(``tiers.Residency``) and both rank eviction victims through the shared
policy registry (``policies``). Two orderings are kept per tier — use order
(for LRU) and insertion order (for FIFO) — because the executor ``touch()``es
an expert on every batch: folding both into one counter silently turned FIFO
into LRU under load in the seed.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional

from repro_torch.memory.policies import EvictionView, make_policy
from repro_torch.memory.tiers import Residency

if TYPE_CHECKING:  # pragma: no cover — repro_torch.core imports this package
    from repro_torch.core.coe import CoEModel


class StateEpoch:
    """Monotone residency-transition counter shared across a hierarchy's
    tiers. Every membership change (pool add/remove, host insert/evict) and
    every ready-set transition bumps it, so consumers can validate cached
    derived state (settled peer holders, queue pending-time predictions)
    with one integer compare instead of rescanning tiers. Pin/unpin and
    LRU touches do NOT bump: they never change what a load would cost."""

    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def bump(self):
        self.n += 1


class ReadySet(set):
    """``DevicePool.ready`` with transition tracking: tests and the warm
    placement path mutate the set directly (``pool.ready.add(eid)``), so the
    set itself bumps the shared epoch on any membership change — a settled
    copy appearing or vanishing invalidates peer-source and pending caches
    without those call sites knowing caches exist."""

    __slots__ = ("epoch",)

    def __init__(self, epoch: StateEpoch, iterable=()):
        super().__init__(iterable)
        self.epoch = epoch

    def add(self, eid):
        if eid not in self:
            self.epoch.bump()
        super().add(eid)

    def discard(self, eid):
        if eid in self:
            self.epoch.bump()
        super().discard(eid)

    def remove(self, eid):
        self.epoch.bump()
        super().remove(eid)

    def pop(self):
        self.epoch.bump()
        return super().pop()

    def clear(self):
        if self:
            self.epoch.bump()
        super().clear()

    def update(self, *others):
        self.epoch.bump()
        super().update(*others)

    def difference_update(self, *others):
        self.epoch.bump()
        super().difference_update(*others)


class DevicePool:
    """Device-memory expert pool (paper §4.1 'model pool').

    One pool per physical memory domain: executors on the same device (the
    paper's 3 GPU executors on one RTX3080Ti) *share* the pool — an expert
    loaded by one executor serves requests from all of them. Pinning is
    therefore counted (several executors may execute the same expert).
    """

    def __init__(self, capacity_bytes: int, coe: CoEModel, group: str = "",
                 epoch: Optional[StateEpoch] = None):
        self.capacity = capacity_bytes
        self.coe = coe
        self.group = group
        self.epoch = epoch if epoch is not None else StateEpoch()
        self.resident: Dict[str, int] = {}    # expert -> last-use counter
        self.insert_seq: Dict[str, int] = {}  # expert -> insertion counter
        self.pinned: Dict[str, int] = {}      # expert -> pin count
        self.ready: ReadySet = ReadySet(self.epoch)   # transfer complete
        self.loading: Dict[str, float] = {}   # expert -> expected done time
        self.used_bytes = 0
        # device bytes held by paged KV-cache blocks (token-level decode):
        # KV competes with expert weights for the same capacity, so
        # ``free_bytes`` subtracts both. Stays 0 when decode is off — the
        # arithmetic below is then bit-identical to the expert-only pool.
        self.kv_bytes = 0
        self.users: List = []                 # executors sharing this pool
        self._clock = 0

    def __contains__(self, expert_id: str) -> bool:
        return expert_id in self.resident

    def resident_ids(self) -> List[str]:
        return list(self.resident)

    def free_bytes(self) -> int:
        return self.capacity - self.used_bytes - self.kv_bytes

    def fits(self, expert_id: str) -> bool:
        return self.coe.spec(expert_id).mem_bytes <= self.capacity

    def touch(self, expert_id: str):
        self._clock += 1
        if expert_id in self.resident:
            self.resident[expert_id] = self._clock

    def pin(self, expert_id: str):
        self.pinned[expert_id] = self.pinned.get(expert_id, 0) + 1

    def unpin(self, expert_id: str):
        n = self.pinned.get(expert_id, 0) - 1
        if n <= 0:
            self.pinned.pop(expert_id, None)
        else:
            self.pinned[expert_id] = n

    def add(self, expert_id: str):
        size = self.coe.spec(expert_id).mem_bytes
        if size > self.free_bytes():
            raise MemoryError(
                f"pool overflow inserting {expert_id}: {size} > {self.free_bytes()}")
        self._clock += 1
        self.resident[expert_id] = self._clock
        self.insert_seq[expert_id] = self._clock
        self.used_bytes += size
        self.epoch.bump()

    def remove(self, expert_id: str):
        if expert_id in self.pinned:
            raise RuntimeError(f"evicting pinned expert {expert_id}")
        self.used_bytes -= self.coe.spec(expert_id).mem_bytes
        self.ready.discard(expert_id)
        self.insert_seq.pop(expert_id, None)
        del self.resident[expert_id]
        self.epoch.bump()

    def evictable(self) -> List[str]:
        return [e for e in self.resident
                if e not in self.pinned and e not in self.loading]

    # ------------------------------------------------------------------ #
    def residency(self, expert_id: str) -> Optional[Residency]:
        """This pool's view of the state machine (None = not here)."""
        if expert_id not in self.resident:
            return None
        if expert_id in self.pinned:
            return Residency.PINNED
        if expert_id in self.loading or expert_id not in self.ready:
            return Residency.LOADING
        return Residency.DEVICE

    def eviction_view(self, incoming_id: Optional[str] = None,
                      load_cost_fn=None, observed_load=None) -> EvictionView:
        cands = [e for e in self.evictable() if e != incoming_id]
        return EvictionView(coe=self.coe, candidates=cands,
                            use_order=self.resident,
                            insert_order=self.insert_seq,
                            resident=set(self.resident),
                            incoming_id=incoming_id,
                            load_cost_fn=load_cost_fn,
                            observed_load=observed_load)

    def snapshot(self) -> dict:
        return {"capacity_bytes": self.capacity,
                "used_bytes": self.used_bytes,
                "kv_bytes": self.kv_bytes,
                "resident": len(self.resident),
                "pinned": len(self.pinned),
                "loading": len(self.loading)}


class HostTier:
    """Host-DRAM expert cache shared by a device's executors (NUMA path).

    Evicted device experts fall back here; demand loads that pass through
    DRAM populate it; the cross-tier prefetcher promotes likely-next experts
    into it ahead of demand (``ready_at`` marks a promotion still in flight
    on the SSD link). Eviction order comes from the shared policy registry
    (probability-ordered for CoServe, LRU for the Samba-CoE baselines).
    """

    def __init__(self, capacity_bytes: int, coe: CoEModel, policy: str = "prob",
                 epoch: Optional[StateEpoch] = None):
        self.capacity = capacity_bytes
        self.coe = coe
        self.policy = policy
        self.epoch = epoch if epoch is not None else StateEpoch()
        self._strategy = make_policy(policy)
        self.resident: Dict[str, int] = {}   # expert -> last-use counter
        self.insert_seq: Dict[str, int] = {}
        self.ready_at: Dict[str, float] = {}  # promotion-in-flight done times
        self.used_bytes = 0
        self._clock = 0
        # live per-expert assignment counts ("observed" policy): the owning
        # CoServeSystem shares its expert_load dict here; None until wired
        self.observed_load = None

    def __contains__(self, expert_id: str) -> bool:
        return expert_id in self.resident

    def free_bytes(self) -> int:
        return self.capacity - self.used_bytes

    def touch(self, expert_id: str):
        self._clock += 1
        if expert_id in self.resident:
            self.resident[expert_id] = self._clock

    def ready_time(self, expert_id: str) -> float:
        """0.0 for settled residents; the SSD-leg completion time for an
        in-flight promotion."""
        return self.ready_at.get(expert_id, 0.0)

    def is_ready(self, expert_id: str, now: float) -> bool:
        return expert_id in self.resident \
            and self.ready_time(expert_id) <= now

    def insert(self, expert_id: str, ready_at: float = 0.0) -> List[str]:
        """Insert (evicting if needed); returns evicted ids.

        An expert larger than the whole tier can never fit: return early
        WITHOUT evicting (the seed emptied the entire cache and then failed
        to insert anyway — a destructive no-op).
        """
        if self.capacity <= 0:
            return []
        size = self.coe.spec(expert_id).mem_bytes
        if size > self.capacity:
            return []
        if expert_id in self.resident:
            self.touch(expert_id)
            # a settled copy never regresses to in-flight; an in-flight one
            # may settle (ready_at == 0) or keep its earlier completion
            if ready_at <= 0.0:
                self.ready_at.pop(expert_id, None)
            return []
        evicted = []
        while self.used_bytes + size > self.capacity and self.resident:
            victim = self._pick_victim()
            if victim is None:
                break
            evicted.append(victim)
            self._remove(victim)
        if self.used_bytes + size <= self.capacity:
            self._clock += 1
            self.resident[expert_id] = self._clock
            self.insert_seq[expert_id] = self._clock
            self.used_bytes += size
            if ready_at > 0.0:
                self.ready_at[expert_id] = ready_at
            self.epoch.bump()
        return evicted

    def _remove(self, expert_id: str):
        self.used_bytes -= self.coe.spec(expert_id).mem_bytes
        self.insert_seq.pop(expert_id, None)
        self.ready_at.pop(expert_id, None)
        del self.resident[expert_id]
        self.epoch.bump()

    def _pick_victim(self) -> Optional[str]:
        if not self.resident:
            return None
        order = self._strategy.order(EvictionView(
            coe=self.coe, candidates=list(self.resident),
            use_order=self.resident, insert_order=self.insert_seq,
            resident=set(self.resident), observed_load=self.observed_load))
        return order[0] if order else None

    def residency(self, expert_id: str) -> Optional[Residency]:
        return Residency.HOST if expert_id in self.resident else None

    def snapshot(self) -> dict:
        return {"capacity_bytes": self.capacity,
                "used_bytes": self.used_bytes,
                "resident": len(self.resident),
                "promotions_in_flight": len(self.ready_at)}
