"""CoE model abstractions: experts, dependencies, routing (paper §2.1).

A CoE model is a pool of *independent* expert models plus an *independent*
routing module. Because routing is user-defined (or separately trained), the
expert dependency graph and per-expert usage probabilities are available
*before* serving — the property CoServe exploits that MoE systems cannot.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ExpertSpec:
    """One expert model in the CoE pool."""
    id: str
    arch: str                          # performance-profile key (same-arch
    #                                    experts are profiled once, paper §4.5)
    mem_bytes: int
    depends_on: Tuple[str, ...] = ()   # preliminary (upstream) experts
    usage_prob: float = 0.0            # pre-assessed P(use) (paper §4.5)
    payload: Any = None                # backend handle (params factory, etc.)

    @property
    def is_dependent(self) -> bool:
        return bool(self.depends_on)


@dataclasses.dataclass
class Request:
    """One inference request targeting a specific expert."""
    id: int
    expert_id: str
    arrival_time: float = 0.0
    task_id: str = ""
    data: Any = None
    parent_id: Optional[int] = None    # set for chained (follow-up) requests
    done_time: Optional[float] = None
    result: Any = None
    # --- online serving metadata (repro_torch.serve) ------------------------- #
    tenant: str = ""                   # multi-tenant attribution key
    deadline: Optional[float] = None   # absolute SLO deadline (arrival + SLO)
    root_arrival_time: Optional[float] = None  # first arrival of the chain:
    #                                    follow-ups inherit it so end-to-end
    #                                    latency spans the whole expert chain

    def e2e_arrival(self) -> float:
        """Arrival time of the chain root (end-to-end latency anchor)."""
        return self.root_arrival_time \
            if self.root_arrival_time is not None else self.arrival_time


class RoutingModule:
    """User-defined routing rules (paper §2.1, §4.5).

    ``first_expert`` maps a raw input to its first expert;
    ``next_expert`` maps (request, expert, output) to a follow-up expert id or
    None. ``chain_prob[e1][e2]`` is the probability that running e1 produces a
    follow-up on e2 (used to pre-assess usage probabilities and prefetch).
    """

    def __init__(self,
                 first_expert_fn: Callable[[Any], str],
                 next_expert_fn: Optional[Callable[[Request, str, Any], Optional[str]]] = None,
                 chain_prob: Optional[Mapping[str, Mapping[str, float]]] = None):
        self._first = first_expert_fn
        self._next = next_expert_fn or (lambda req, eid, out: None)
        self.chain_prob = {k: dict(v) for k, v in (chain_prob or {}).items()}

    def first_expert(self, data: Any) -> str:
        return self._first(data)

    def next_expert(self, req: Request, expert_id: str, output: Any) -> Optional[str]:
        return self._next(req, expert_id, output)


class CoEModel:
    """Expert pool + routing + derived dependency/probability metadata."""

    def __init__(self, experts: Sequence[ExpertSpec], routing: RoutingModule):
        self.experts: Dict[str, ExpertSpec] = {e.id: e for e in experts}
        if len(self.experts) != len(experts):
            raise ValueError("duplicate expert ids")
        self.routing = routing
        # cached usage-descending catalog order (``by_usage`` is called per
        # placement proposal and per replay warm-up — the sort dominated
        # search profiles); None until first use, dropped on catalog mutation
        self._by_usage_cache: Optional[List[ExpertSpec]] = None
        self._by_usage_len = -1
        # downstream map: upstream expert -> experts that depend on it
        self.downstream: Dict[str, List[str]] = {e.id: [] for e in experts}
        for e in experts:
            for up in e.depends_on:
                if up not in self.experts:
                    raise ValueError(f"{e.id} depends on unknown expert {up}")
                self.downstream[up].append(e.id)

    def __len__(self) -> int:
        return len(self.experts)

    def spec(self, expert_id: str) -> ExpertSpec:
        return self.experts[expert_id]

    def total_bytes(self) -> int:
        return sum(e.mem_bytes for e in self.experts.values())

    # ------------------------------------------------------------------ #
    # usage probabilities (paper §4.5: compute from routing rules + the
    # known input distribution, or estimate from a sample run)
    # ------------------------------------------------------------------ #
    def assess_usage_probabilities(
            self, input_distribution: Mapping[Any, float]) -> "CoEModel":
        """Return a copy whose experts carry P(use) derived from the routing
        rules and a known distribution over raw inputs."""
        probs: Dict[str, float] = {eid: 0.0 for eid in self.experts}
        for data, p in input_distribution.items():
            first = self.routing.first_expert(data)
            probs[first] += p
        # propagate through chains: P(e2) += P(e1) * chain_prob[e1][e2]
        order = self._topo_order()
        for eid in order:
            for nxt, cp in self.routing.chain_prob.get(eid, {}).items():
                probs[nxt] += probs[eid] * cp
        experts = [dataclasses.replace(e, usage_prob=probs[e.id])
                   for e in self.experts.values()]
        return CoEModel(experts, self.routing)

    def estimate_usage_from_samples(self, sample_inputs: Sequence[Any]) -> "CoEModel":
        """Paper's fallback for ambiguous (trained) routers: run routing over
        a small sample set and count first-expert frequencies + chains."""
        counts = {eid: 0.0 for eid in self.experts}
        for data in sample_inputs:
            counts[self.routing.first_expert(data)] += 1.0
        n = max(1, len(sample_inputs))
        dist = {eid: c / n for eid, c in counts.items()}
        order = self._topo_order()
        for eid in order:
            for nxt, cp in self.routing.chain_prob.get(eid, {}).items():
                dist[nxt] = dist.get(nxt, 0.0) + dist[eid] * cp
        experts = [dataclasses.replace(e, usage_prob=dist.get(e.id, 0.0))
                   for e in self.experts.values()]
        return CoEModel(experts, self.routing)

    def _topo_order(self) -> List[str]:
        seen: Dict[str, int] = {}
        out: List[str] = []

        def visit(eid: str):
            state = seen.get(eid, 0)
            if state == 1:
                raise ValueError("dependency cycle in CoE graph")
            if state == 2:
                return
            seen[eid] = 1
            for down in self.downstream.get(eid, []):
                visit(down)
            seen[eid] = 2
            out.append(eid)

        for eid in self.experts:
            visit(eid)
        out.reverse()
        return out

    # sorted by usage probability, descending (init placement, paper §4.1)
    def by_usage(self) -> List[ExpertSpec]:
        """Cached: specs are immutable dataclass copies and the catalog dict
        is fixed at construction, so the sort is computed once. A changed
        catalog *size* invalidates automatically; code that swaps specs
        in-place at the same size must call ``invalidate_catalog_cache``.
        Returns a fresh list so callers may mutate their copy."""
        if self._by_usage_cache is None \
                or self._by_usage_len != len(self.experts):
            self._by_usage_cache = sorted(
                self.experts.values(), key=lambda e: (-e.usage_prob, e.id))
            self._by_usage_len = len(self.experts)
        return list(self._by_usage_cache)

    def invalidate_catalog_cache(self):
        """Drop derived catalog order after an in-place ``experts`` mutation
        that kept the size unchanged (tests / notebooks)."""
        self._by_usage_cache = None
        self._by_usage_len = -1
