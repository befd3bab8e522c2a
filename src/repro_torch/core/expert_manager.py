"""Dependency-aware expert management (paper §4.3).

The eviction *order* is a pluggable per-tier strategy from
``repro_torch.memory.policies`` (the same registry the host tier uses); this
manager owns the device-pool mechanics around it: how much must be freed,
which experts are protected by queued work, and the two-stage CoServe
semantics documented on ``DependencyProbPolicy``:

  Stage 1 — evict *dependent* experts whose preliminary (upstream) experts
  are not resident: they cannot execute until their upstream loads, so they
  only waste pool memory. Sorted by memory footprint **descending**.
  Stage 2 — if still short, evict by pre-assessed usage probability
  **ascending** (the CoE prior replaces Samba-CoE's LRU history).

``load_cost_fn`` (cost-aware policies) is residency-aware since the fleet
refactor: the executor passes the memory hierarchy's assignment cost, so a
victim's reload price reflects the tier it would come back from (HOST vs
DISK) and the backlog of the specific device link it would ride — the same
number the scheduler scores assignments with.
"""
from __future__ import annotations

from typing import List, Optional, Set

from repro_torch.core.coe import CoEModel
from repro_torch.memory.policies import make_policy
from repro_torch.memory.residency import DevicePool


class ExpertManager:
    def __init__(self, coe: CoEModel, policy: str = "dependency_prob"):
        self.coe = coe
        self.policy = policy
        self.strategy = make_policy(policy)   # raises on unknown names
        # live per-expert assignment counts for the "observed" policy: the
        # owning CoServeSystem shares its expert_load dict (same object, so
        # updates are visible without re-wiring); None = cold start
        self.observed_load = None

    # ------------------------------------------------------------------ #
    def pick_victims(self, pool: DevicePool, incoming_id: str,
                     load_cost_fn=None, protected: Optional[Set[str]] = None,
                     strict: bool = False) -> Optional[List[str]]:
        """Experts to evict so ``incoming_id`` fits; None if impossible.

        ``protected`` marks experts with queued work on this executor:
        with ``strict`` (prefetch path) they are never evicted — a prefetch
        that displaces pending work thrashes (measured: a hot expert reloads
        40+ times); without ``strict`` (demand path) they are only evicted
        after all unprotected candidates are exhausted."""
        need = self.coe.spec(incoming_id).mem_bytes - pool.free_bytes()
        if need <= 0:
            return []
        order = self._eviction_order(pool, incoming_id, load_cost_fn)
        protected = protected or set()
        if protected:
            unprot = [e for e in order if e not in protected]
            order = unprot if strict else unprot + [e for e in order
                                                    if e in protected]
        victims, freed = [], 0
        for eid in order:
            if freed >= need:
                break
            victims.append(eid)
            freed += self.coe.spec(eid).mem_bytes
        if freed < need:
            return None
        return victims

    # ------------------------------------------------------------------ #
    def _eviction_order(self, pool: DevicePool, incoming_id: str,
                        load_cost_fn=None) -> List[str]:
        return self.strategy.order(
            pool.eviction_view(incoming_id, load_cost_fn,
                               observed_load=self.observed_load))

    # ------------------------------------------------------------------ #
    def ensure_loadable(self, pool: DevicePool, expert_id: str,
                        load_cost_fn=None, protected: Optional[Set[str]] = None,
                        strict: bool = False) -> Optional[List[str]]:
        """Evict (mutating the pool) until expert fits; returns evicted ids or
        None if the expert cannot fit (e.g. larger than the whole pool)."""
        if not pool.fits(expert_id):
            return None
        victims = self.pick_victims(pool, expert_id, load_cost_fn,
                                    protected=protected, strict=strict)
        if victims is None:
            return None
        for v in victims:
            pool.remove(v)
        return victims
