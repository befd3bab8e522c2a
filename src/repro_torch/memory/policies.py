"""Pluggable eviction policies, shared by every tier of the hierarchy.

Source of truth: the only place eviction *order* is defined — the device
pool's manager and the host tier both consume this registry, so a policy
name means the same ranking on every tier.

The seed hard-coded eviction orders twice: once in ``ExpertManager`` (device
pool) and once in ``HostCache._pick_victim`` (host tier), with subtly
different semantics. A policy is now one object implementing ``order``:
given the evictable candidates and a view of the tier, return them
best-victim-first. The device-pool manager and the host tier both consume
the same registry, so ``--policy``-style knobs mean the same thing on every
tier.

Policies (paper §4.3 + baselines + beyond-paper):

  dependency_prob  CoServe two-stage order: first *blocked* dependent
                   experts (no preliminary expert resident), by footprint
                   descending; then by pre-assessed P(use) ascending.
  prob             P(use) ascending (CoServe's stage 2 alone).
  lru              least-recently-used first (Samba-CoE history baseline).
  fifo             oldest *insertion* first — insertion order is tracked
                   separately from use order, so ``touch()`` (which the
                   executor calls on every batch) cannot perturb it. The
                   seed conflated the two counters, silently turning FIFO
                   into LRU under load.
  cost_benefit     P(use) * reload_cost / byte ascending (beyond-paper).
  observed         least *observed* load first (``CoServeSystem.expert_load``
                   assignment counts), with the ``dependency_prob`` order as
                   the cold-start fallback and tie-break — when traffic
                   diverges from the static priors (the regime the placement
                   search wins in), eviction stops thrashing the truly-hot
                   experts (ROADMAP "Eviction under wrong priors").
"""
from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Callable, Dict, List, Mapping, Optional,
                    Set)

if TYPE_CHECKING:  # pragma: no cover — repro_torch.core imports this package
    from repro_torch.core.coe import CoEModel

POLICY_NAMES = ("dependency_prob", "lru", "fifo", "prob", "cost_benefit",
                "observed")


@dataclasses.dataclass
class EvictionView:
    """What a policy may look at when ranking victims on one tier."""
    coe: "CoEModel"
    candidates: List[str]                  # evictable experts on this tier
    use_order: Mapping[str, int]           # expert -> last-use counter
    insert_order: Mapping[str, int]        # expert -> insertion counter
    resident: Set[str]                     # everything resident on this tier
    incoming_id: Optional[str] = None      # expert the eviction makes room for
    load_cost_fn: Optional[Callable[[str], float]] = None
    observed_load: Optional[Mapping[str, float]] = None
    #                                      # live per-expert assignment counts
    #                                      # (CoServeSystem.expert_load); None
    #                                      # or empty = nothing observed yet


class EvictionPolicy:
    """Ranks eviction candidates, best victim first."""
    name = "base"

    def order(self, view: EvictionView) -> List[str]:
        raise NotImplementedError


class LRUPolicy(EvictionPolicy):
    name = "lru"

    def order(self, view: EvictionView) -> List[str]:
        return sorted(view.candidates, key=lambda e: view.use_order[e])


class FIFOPolicy(EvictionPolicy):
    name = "fifo"

    def order(self, view: EvictionView) -> List[str]:
        return sorted(view.candidates, key=lambda e: view.insert_order[e])


class ProbPolicy(EvictionPolicy):
    name = "prob"

    def order(self, view: EvictionView) -> List[str]:
        return sorted(view.candidates,
                      key=lambda e: (view.coe.spec(e).usage_prob, e))


class CostBenefitPolicy(EvictionPolicy):
    name = "cost_benefit"

    def order(self, view: EvictionView) -> List[str]:
        def cb(eid: str):
            s = view.coe.spec(eid)
            reload_cost = view.load_cost_fn(eid) if view.load_cost_fn else 1.0
            return (s.usage_prob * reload_cost / max(1, s.mem_bytes), eid)
        return sorted(view.candidates, key=cb)


class DependencyProbPolicy(EvictionPolicy):
    """CoServe two-stage order (paper Fig. 10)."""
    name = "dependency_prob"

    def order(self, view: EvictionView) -> List[str]:
        resident = set(view.resident)
        if view.incoming_id is not None:
            resident.add(view.incoming_id)
        stage1, rest = [], []
        for eid in view.candidates:
            spec = view.coe.spec(eid)
            # blocked = a downstream expert none of whose preliminary experts
            # is resident: it cannot receive work until one of them loads
            blocked = spec.is_dependent and not any(
                up in resident for up in spec.depends_on)
            (stage1 if blocked else rest).append(eid)
        stage1.sort(key=lambda e: (-view.coe.spec(e).mem_bytes, e))
        rest.sort(key=lambda e: (view.coe.spec(e).usage_prob, e))
        return stage1 + rest


class ObservedLoadPolicy(EvictionPolicy):
    """Least observed load first; ``dependency_prob`` as cold-start fallback.

    ``view.observed_load`` carries the live assignment counts the system
    accumulated online. Before any traffic exists (or for experts that never
    received a request) the ranking degrades exactly to the two-stage
    ``dependency_prob`` order, so a cold system behaves like the paper's
    policy and diverging traffic re-ranks victims by what actually ran.
    """
    name = "observed"

    def order(self, view: EvictionView) -> List[str]:
        fallback = DependencyProbPolicy().order(view)
        if not view.observed_load:
            return fallback
        rank = {e: i for i, e in enumerate(fallback)}
        return sorted(view.candidates,
                      key=lambda e: (view.observed_load.get(e, 0), rank[e]))


_REGISTRY: Dict[str, type] = {p.name: p for p in (
    LRUPolicy, FIFOPolicy, ProbPolicy, CostBenefitPolicy,
    DependencyProbPolicy, ObservedLoadPolicy)}


def make_policy(name: str) -> EvictionPolicy:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(f"unknown eviction policy {name!r} "
                         f"(choose from {sorted(_REGISTRY)})") from None
