"""Dependency-aware cross-tier prefetch (disk -> host ahead of demand).

Source of truth: the only issuer of speculative disk->host promotions, and
the owner of the speculation gates (``max_backlog_s`` /
``overlap_backlog_s``) that keep *all* speculative traffic — including the
executors' overlap prefetch, which asks ``speculation_ok`` — from queueing
ahead of demand loads.

The paper exploits the CoE dependency graph for device-pool *eviction*
(§4.3); the same property predicts *future loads*: while an upstream expert
executes, its likely downstream experts — weighted by the routing edge
probability times the downstream expert's pre-assessed P(use) — can be
promoted from disk into host DRAM so the eventual demand load pays only the
PCIe leg instead of the full SSD read (eMoE 2025 makes the same argument for
MoE gate predictions). Promotions ride the *shared* SSD channel, so the
prefetcher only issues them while the link is idle: a speculative read must
never queue ahead of demand traffic.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Set, Tuple

if TYPE_CHECKING:  # pragma: no cover — repro_torch.core imports this package
    from repro_torch.core.coe import CoEModel


@dataclasses.dataclass(frozen=True)
class PrefetchConfig:
    enabled: bool = True
    trigger: str = "exec"          # exec: promote when the upstream *starts
    #                                executing* (narrow window, demand-certain)
    #                                queue: promote when the upstream *joins a
    #                                queue* (wider overlap window, more
    #                                speculative SSD traffic — the downstream
    #                                demand is further from certain)
    min_weight: float = 0.01       # skip edges below this likelihood
    max_per_trigger: int = 2       # SSD reads issued per upstream execution
    max_backlog_s: float = 0.25    # only promote while the SSD link's queue
    #                                is shorter than this — a speculation must
    #                                not push demand traffic far back
    overlap_backlog_s: float = 1.0  # gate for device-pool overlap prefetch:
    #                                 its target has queued work (the load is
    #                                 certain, only its early issue order is
    #                                 speculative), so it tolerates a longer
    #                                 backlog than disk->host promotion


class CrossTierPrefetcher:
    """Promotes likely downstream experts disk -> host while their upstream
    executes. Owned by ``MemoryHierarchy``; inert on UMA (no host tier)."""

    def __init__(self, coe: "CoEModel", hierarchy, config: PrefetchConfig):
        if config.trigger not in ("exec", "queue"):
            raise ValueError(f"unknown prefetch trigger {config.trigger!r} "
                             "(expected 'exec' or 'queue')")
        self.coe = coe
        self.hierarchy = hierarchy
        self.config = config
        self.promotions = 0          # disk->host transfers issued
        self.promoted_bytes = 0      # speculative SSD traffic those cost
        self.hits = 0                # device loads served from a promotion
        self.evicted_unused = 0      # promotions lost from host before use
        self._promoted: Set[str] = set()

    # ------------------------------------------------------------------ #
    def candidates(self, upstream_id: str) -> List[Tuple[str, float]]:
        """(downstream expert, likelihood) pairs, most likely first.

        The routing module's ``chain_prob`` edges are the primary signal;
        declared ``depends_on`` edges without a routing probability fall back
        to the downstream expert's P(use) alone.
        """
        weights: Dict[str, float] = {}
        for nxt, cp in self.coe.routing.chain_prob.get(upstream_id, {}).items():
            p_use = self.coe.spec(nxt).usage_prob
            weights[nxt] = cp * (p_use if p_use > 0 else 1.0)
        for nxt in self.coe.downstream.get(upstream_id, []):
            weights.setdefault(nxt, self.coe.spec(nxt).usage_prob)
        return sorted(weights.items(), key=lambda kv: (-kv[1], kv[0]))

    # ------------------------------------------------------------------ #
    def on_execute(self, upstream_id: str, now: float):
        """Upstream expert starts executing: promote its likely followers.
        Fires under both triggers — with ``trigger="queue"`` the window
        *opens* at queue arrival, and execution start stays the last chance
        for anything the backlog gate deferred."""
        self._promote_followers(upstream_id, now)

    def on_enqueue(self, upstream_id: str, now: float):
        """Upstream expert joined a queue (group formed, not yet head): the
        queue-arrival trigger widens the overlap window to start here,
        buying more load/compute overlap per promotion but speculating
        further ahead of demand — the queued group may sit for a while, or
        the chain may never fire, so it costs more speculative SSD traffic."""
        if self.config.trigger == "queue":
            self._promote_followers(upstream_id, now)

    def _promote_followers(self, upstream_id: str, now: float):
        h = self.hierarchy
        if not self.config.enabled or h.host is None:
            return
        issued = 0
        for eid, w in self.candidates(upstream_id):
            if issued >= self.config.max_per_trigger:
                break
            if w < self.config.min_weight:
                break               # sorted descending: the rest are colder
            if eid in h.host or h.on_any_device(eid):
                continue            # already past the disk tier
            backlog = h.topology.disk_channel.busy_until - now
            if backlog > self.config.max_backlog_s:
                break               # demand traffic owns the SSD link
            mem = self.coe.spec(eid).mem_bytes
            if mem > h.host.capacity:
                continue
            leg = h.transfer.begin_host_promotion(now, mem, label=eid)
            evicted = h.host.insert(eid, ready_at=leg.done)
            # evicting settled host residents for a speculation is fine: the
            # policy already ranked them colder than this promotion's weight
            self.note_host_evictions(evicted)
            if eid in h.host:
                self.promotions += 1
                self.promoted_bytes += mem
                self._promoted.add(eid)
                issued += 1

    def note_host_evictions(self, evicted):
        """Promotions displaced from the host tier before any demand load
        saw them are wasted speculation — count them honestly."""
        self.evicted_unused += sum(1 for v in evicted if v in self._promoted)
        self._promoted.difference_update(evicted)

    def note_device_load(self, expert_id: str, served_from_host: bool):
        """Telemetry: a device load consumed (or missed) a promotion."""
        if expert_id in self._promoted:
            if served_from_host:
                self.hits += 1
            self._promoted.discard(expert_id)

    def snapshot(self) -> dict:
        return {"promotions": self.promotions, "hits": self.hits,
                "promoted_bytes": self.promoted_bytes,
                "trigger": self.config.trigger,
                "evicted_unused": self.evicted_unused,
                "outstanding": len(self._promoted)}
