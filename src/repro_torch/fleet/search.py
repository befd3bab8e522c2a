"""Cost-model placement search: plans scored by the serving cost model.

Source of truth: this module owns HOW a ``PlacementPlan`` is chosen beyond
the greedy hot-first sweep — but it never invents a cost formula. Every
candidate plan is priced by replaying a workload trace through
``MemoryHierarchy.assignment_cost``, the same residency-aware,
contended-channel formula the online scheduler assigns requests with, so
the search optimizes exactly what serving pays (SN40L-style searched
composition-of-experts layouts; the QoS-Efficient Multi-MoE partial
reconfiguration argument).

  ``WorkloadTrace``      an expert-id sequence plus replay clock spacing.
                         Built from offline profiler traces / materialized
                         request lists (``trace_from_requests``, expected
                         routing chains included), from observed online
                         per-expert load (``trace_from_counts``), or from
                         static pre-assessed P(use) (``trace_from_usage``).
  ``replay_cost``        score one plan: warm a fresh ``MemoryHierarchy`` to
                         the plan's layout, then charge every trace event
                         the queueing-plus-switch cost of its best device
                         pool. Misses occupy the contended SSD/PCIe/peer
                         channels and per-pool service clocks advance, so a
                         plan that serializes the hot head of the
                         distribution behind one pool or one link is
                         penalized — the signal replication exists for.
  ``search_placement``   greedy local search (replicate / drop / migrate /
                         swap / place moves) from the greedy-sweep seed
                         plan. Accept-only-improvements plus a seed-plan
                         fallback guarantee the result never scores worse
                         than the greedy sweep on the same trace (pinned by
                         test); every candidate is materialized through
                         ``PlacementPlan.from_assignments``, so capacity and
                         replica-budget invariants hold by construction.

The replay is a static-residency approximation: the plan's layout is held
fixed (no eviction churn) and execution time is a per-event constant. The
event-driven simulator stays the ground truth — the search only needs the
*relative* ordering of candidate plans, and BENCH_placement.json checks the
ordering against full simulations.
"""
from __future__ import annotations

import collections
import dataclasses
import time as _time
from typing import TYPE_CHECKING, Dict, FrozenSet, List, Mapping, Optional, \
    Sequence, Tuple

import numpy as np

from repro_torch.fleet.placement import PlacementPlan
from repro_torch.memory import MemoryHierarchy, TierSpec

if TYPE_CHECKING:  # pragma: no cover — repro_torch.core imports this package
    from repro_torch.core.coe import CoEModel


# --------------------------------------------------------------------------- #
# workload traces
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class WorkloadTrace:
    """A concrete expert-demand sequence the cost model replays.

    ``gap_s`` spaces the replay clock between events (arrival cadence);
    ``exec_s`` is the constant per-event service time that advances a
    pool's busy clock — together they set how much queueing pressure the
    replay sees (gap < exec means queues build and replication pays)."""
    events: Tuple[str, ...]
    gap_s: float = 0.004
    exec_s: float = 0.020

    def weights(self) -> Dict[str, int]:
        """Per-expert event counts (the search's hot/cold ranking)."""
        return dict(collections.Counter(self.events))

    # --- artifact serialization (repro_torch.api.artifacts wraps file io) ----- #
    def to_dict(self) -> dict:
        """Lossless JSON-ready form; ``from_dict(to_dict(t)) == t``."""
        return {"events": list(self.events), "gap_s": self.gap_s,
                "exec_s": self.exec_s}

    @classmethod
    def from_dict(cls, d: Mapping) -> "WorkloadTrace":
        try:
            events = tuple(str(e) for e in d["events"])
        except (KeyError, TypeError):
            raise ValueError(
                "workload trace dict needs an 'events' list of expert ids "
                f"(got keys {sorted(d)})") from None
        return cls(events, gap_s=float(d.get("gap_s", 0.004)),
                   exec_s=float(d.get("exec_s", 0.020)))


def trace_from_requests(coe: "CoEModel", requests: Sequence,
                        gap_s: float = 0.004, exec_s: float = 0.020,
                        chain_threshold: float = 0.5) -> WorkloadTrace:
    """Trace from a materialized request list (offline profiler trace): each
    request contributes its first expert plus the *expected* routing chain —
    the likeliest ``chain_prob`` successor is appended while its edge
    probability clears ``chain_threshold``, so shared downstream experts
    (the detection stage) carry their real aggregate traffic."""
    events: List[str] = []
    for r in requests:
        eid = r.expert_id
        events.append(eid)
        seen = {eid}
        cur = eid
        while True:
            edges = coe.routing.chain_prob.get(cur, {})
            if not edges:
                break
            nxt, p = max(edges.items(), key=lambda kv: (kv[1], kv[0]))
            if p < chain_threshold or nxt in seen:
                break
            events.append(nxt)
            seen.add(nxt)
            cur = nxt
    return WorkloadTrace(tuple(events), gap_s=gap_s, exec_s=exec_s)


def trace_from_counts(counts: Mapping[str, float], length: int = 512,
                      gap_s: float = 0.004,
                      exec_s: float = 0.020) -> WorkloadTrace:
    """Deterministic trace proportional to observed per-expert load (e.g.
    ``CoServeSystem.expert_load``): each expert gets round(share * length)
    events (at least one while its count is positive), interleaved evenly so
    the replay sees mixed traffic instead of sorted runs."""
    total = float(sum(v for v in counts.values() if v > 0))
    if total <= 0:
        return WorkloadTrace((), gap_s=gap_s, exec_s=exec_s)
    slots: List[Tuple[float, str]] = []
    for eid in sorted(counts):
        c = counts[eid]
        if c <= 0:
            continue
        n = max(1, int(round(length * (c / total))))
        for k in range(n):
            slots.append(((k + 0.5) / n, eid))
    slots.sort()
    return WorkloadTrace(tuple(eid for _, eid in slots),
                         gap_s=gap_s, exec_s=exec_s)


def trace_from_usage(coe: "CoEModel", length: int = 512,
                     gap_s: float = 0.004,
                     exec_s: float = 0.020) -> WorkloadTrace:
    """Trace from the static pre-assessed P(use) (paper §4.5) — what the
    online path uses before any load has been observed."""
    return trace_from_counts(
        {e.id: e.usage_prob for e in coe.experts.values()},
        length=length, gap_s=gap_s, exec_s=exec_s)


# --------------------------------------------------------------------------- #
# cost model
# --------------------------------------------------------------------------- #

def _device_groups(capacities: Mapping[str, int],
                   pool_devices: Optional[Mapping[str, str]]) -> List[str]:
    devices = pool_devices or {}
    return sorted(g for g in capacities
                  if devices.get(g, "gpu") not in ("host", "cpu"))


def _host_groups(capacities: Mapping[str, int],
                 pool_devices: Optional[Mapping[str, str]]) -> List[str]:
    """The host/CPU pool groups — candidate targets of the ``host_place``
    move (deliberate CPU residents under heterogeneous co-execution)."""
    devices = pool_devices or {}
    return sorted(g for g in capacities
                  if devices.get(g, "gpu") in ("host", "cpu"))


@dataclasses.dataclass
class _ReplayDetail:
    """Per-event decomposition of one full replay — the anchor the delta
    scorer perturbs. For every counted event i and group index gi it keeps
    the pool backlog (``wait_at``), the would-be host/disk miss price
    (``hostmiss``), the peer-ingress backlog (``peer_wait``; empty rows when
    the tier has no fabric) and the cost actually charged (``paid``), all
    recorded during the anchor replay with the pool busy clocks and channel
    state it really saw. A single-expert move re-prices only that expert's
    events against these frozen backgrounds.

    With host co-execution columns (``host_place``), ``groups`` carries the
    device groups first and the host/CPU groups after; ``host_set`` marks
    the host columns, whose events pay ``exec_pen`` (the extra CPU service
    time over the device exec constant) on top of their wait/switch, and
    whose ``hostmiss`` column is the host-arm assignment cost (never the
    device PCIe formula). ``peer_wait`` rows stay device-column-only."""
    groups: List[str]
    has_peer: bool = False
    total: float = 0.0
    n: int = 0
    paid: List[float] = dataclasses.field(default_factory=list)
    wait_at: List[List[float]] = dataclasses.field(default_factory=list)
    hostmiss: List[List[float]] = dataclasses.field(default_factory=list)
    peer_wait: List[List[float]] = dataclasses.field(default_factory=list)
    peer_pred: Dict[str, float] = dataclasses.field(default_factory=dict)
    events_of: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    host_set: FrozenSet[str] = frozenset()
    exec_pen: float = 0.0

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0


def _replay(coe: "CoEModel", capacities: Mapping[str, int],
            plan: PlacementPlan, trace: WorkloadTrace,
            tier: TierSpec, links: str = "shared",
            pool_devices: Optional[Mapping[str, str]] = None,
            record: bool = False,
            host_groups: Sequence[str] = (),
            host_exec_s: float = 0.0) -> _ReplayDetail:
    """The replay loop behind ``replay_cost``; with ``record`` it also
    captures the per-event backgrounds the delta scorer needs. Recording
    adds only *pure* probes (``host_disk_cost``, channel backlog reads), so
    the accumulated cost is bit-identical with and without it.

    ``host_groups`` (heterogeneous co-execution) adds the named host/CPU
    pools as candidate execution arms: their events pay the host-arm
    assignment cost (free for DRAM residents) plus the extra CPU service
    time ``host_exec_s - exec_s``, and their misses ride the SSD link only.
    Empty ``host_groups`` leaves every cost bit-identical to before."""
    groups = _device_groups(capacities, pool_devices)
    host_list = [g for g in host_groups if g in capacities]
    detail = _ReplayDetail(groups=groups + host_list,
                           host_set=frozenset(host_list))
    if not groups or not trace.events:
        return detail
    h = MemoryHierarchy(coe, tier, pools=dict(capacities), links=links,
                        link_groups=groups)
    detail.has_peer = h.topology.has_peer
    pen = max(0.0, host_exec_s - trace.exec_s) if host_list else 0.0
    detail.exec_pen = pen
    if host_list:
        h.host_exec_enabled = True
    for eid, g in plan.layout():
        pool = h.pools.get(g)
        if pool is not None and eid not in pool \
                and coe.spec(eid).mem_bytes <= pool.free_bytes():
            pool.add(eid)
            pool.ready.add(eid)
    if h.host is not None:
        # steady state: DRAM holds as much of the hot catalog as it can
        for spec in coe.by_usage():
            if spec.mem_bytes <= h.host.free_bytes():
                h.host.insert(spec.id)
    busy = {g: 0.0 for g in groups + host_list}
    now, cost, n = 0.0, 0.0, 0
    for eid in trace.events:
        if eid not in coe.experts:
            continue
        best_g, best_total, best_switch = None, 0.0, 0.0
        best_host = False
        waits: List[float] = []
        for g in groups:
            switch = 0.0 if eid in h.pools[g] \
                else h.assignment_cost(eid, now, group=g)
            wait = max(0.0, busy[g] - now)
            if record:
                waits.append(wait)
            total = wait + switch
            if best_g is None or total < best_total:
                best_g, best_total, best_switch = g, total, switch
                best_host = False
        for g in host_list:
            # device arms win ties (strict <): hetero only reroutes a batch
            # when the host arm is genuinely cheaper
            switch = 0.0 if eid in h.pools[g] \
                else h.assignment_cost(eid, now, group=g, device="cpu")
            wait = max(0.0, busy[g] - now)
            if record:
                waits.append(wait)
            total = wait + switch + pen
            if total < best_total:
                best_g, best_total, best_switch = g, total, switch
                best_host = True
        cost += best_total
        n += 1
        if record:
            detail.paid.append(best_total)
            detail.wait_at.append(waits)
            detail.hostmiss.append(
                [h.host_disk_cost(eid, now, group=g) for g in groups]
                + [h.assignment_cost(eid, now, group=g, device="cpu")
                   for g in host_list])
            if detail.has_peer:
                detail.peer_wait.append(
                    [max(0.0, h.topology.peer_for(g).busy_until - now)
                     for g in groups])
                if eid not in detail.peer_pred:
                    detail.peer_pred[eid] = h.transfer.predict_peer(
                        coe.spec(eid).mem_bytes)
            detail.events_of.setdefault(eid, []).append(n - 1)
        if eid not in h.pools[best_g]:
            if best_host:
                # a host-arm miss is a disk -> DRAM load: SSD link only,
                # never the device PCIe formula
                h.begin_host_load(eid, now)
            else:
                h.begin_device_load(eid, now, group=best_g)
        busy[best_g] = max(now, busy[best_g]) + best_switch \
            + (host_exec_s if best_host else trace.exec_s)
        now += trace.gap_s
    detail.total, detail.n = cost, n
    return detail


def replay_cost(coe: "CoEModel", capacities: Mapping[str, int],
                plan: PlacementPlan, trace: WorkloadTrace,
                tier: TierSpec, links: str = "shared",
                pool_devices: Optional[Mapping[str, str]] = None,
                host_groups: Sequence[str] = (),
                host_exec_s: float = 0.0) -> float:
    """Mean per-event queueing + switch seconds of serving ``trace`` under
    ``plan``'s (static) layout.

    A fresh ``MemoryHierarchy`` is warmed to the plan (device pools hold the
    planned copies, host DRAM fills hottest-first with the rest), then each
    event is assigned to the device pool minimizing
    ``pool busy backlog + assignment_cost`` — the same two terms the online
    scheduler's makespan argmin weighs. Misses start real transfers on the
    contended channels (SSD / per-group PCIe / peer ingress), so hot experts
    crowded behind one link keep getting more expensive within the replay,
    exactly as they would in the simulator. ``host_groups``/``host_exec_s``
    add host co-execution arms (see ``_replay``)."""
    return _replay(coe, capacities, plan, trace, tier, links=links,
                   pool_devices=pool_devices, host_groups=host_groups,
                   host_exec_s=host_exec_s).mean


class _DeltaScorer:
    """Scores assignment perturbations against a full-replay anchor.

    For each expert whose pool set differs from the anchor's, every one of
    its trace events is re-priced as ``min over groups`` of the recorded
    pool backlog plus: zero (resident under the candidate), the peer-copy
    price (fabric present and a sibling copy exists), or the recorded
    host/disk miss price. Events of unchanged experts keep their anchor
    cost, and cross-event busy-clock drift is ignored — the approximation
    periodic full-replay revalidation (and the final full replay) corrects,
    so accepted estimates never leak into the returned cost."""

    def __init__(self, detail: _ReplayDetail,
                 anchor_assign: Mapping[str, Sequence[str]]):
        self.d = detail
        self.anchor: Dict[str, FrozenSet[str]] = {
            e: frozenset(p) for e, p in anchor_assign.items() if p}

    def changed(self, assign: Mapping[str, Sequence[str]]) -> List[str]:
        """Experts whose pool set differs from the anchor's."""
        out = []
        # sorted: the caller sums float deltas in this order, so hash-order
        # iteration would make the estimate depend on PYTHONHASHSEED
        for e in sorted(assign.keys() | self.anchor.keys()):
            if frozenset(assign.get(e) or ()) != \
                    self.anchor.get(e, frozenset()):
                out.append(e)
        return out

    def estimate(self, assign: Mapping[str, Sequence[str]]) -> float:
        """Estimated mean replay cost of ``assign`` (anchor scale)."""
        d = self.d
        delta = 0.0
        for eid in self.changed(assign):
            pools = frozenset(assign.get(eid) or ())
            for i in d.events_of.get(eid, ()):
                delta += self._event_best(i, eid, pools) - d.paid[i]
        return (d.total + delta) / d.n if d.n else 0.0

    def _event_best(self, i: int, eid: str,
                    pools: FrozenSet[str]) -> float:
        d = self.d
        waits = d.wait_at[i]
        miss_host = d.hostmiss[i]
        host_set = d.host_set
        # only a *device* copy can seed a peer (pool -> pool) forward — a
        # host-pool placement never rides the fabric
        peer_ok = d.has_peer and any(p not in host_set for p in pools)
        peer_base = d.peer_pred.get(eid, 0.0) if peer_ok else 0.0
        best = None
        for gi, g in enumerate(d.groups):
            if g in host_set:   # host co-execution arm: wait + host-arm
                #                 switch + the extra CPU service time
                c = waits[gi] + d.exec_pen if g in pools \
                    else waits[gi] + miss_host[gi] + d.exec_pen
            elif g in pools:
                c = waits[gi]
            elif peer_ok:   # any planned device copy is a sibling of g here
                c = waits[gi] + peer_base + d.peer_wait[i][gi]
            else:
                c = waits[gi] + miss_host[gi]
            if best is None or c < best:
                best = c
        return best if best is not None else 0.0


# --------------------------------------------------------------------------- #
# local search
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class SearchConfig:
    iterations: int = 400        # move proposals (delta: scored by the
    #                              anchor decomposition; full: one replay each)
    patience: int = 120          # stop after this many consecutive rejects
    seed: int = 0                # RNG seed (the search is deterministic
    #                              unless time_budget_s is set)
    replication: int = 2         # max planned copies beyond the primary
    replica_fraction: float = 0.35   # per-pool replica byte budget the
    #                                  search may spend (the greedy sweep's
    #                                  0.10 stays its own default)
    hot_pool: int = 32           # replicate/drop candidates come from the
    #                              hottest / coldest end of the trace weights
    scoring: str = "delta"       # delta (anchor + per-expert re-pricing,
    #                              periodic full-replay revalidation) | full
    #                              (every proposal replays the whole trace)
    revalidate_every: int = 8    # delta mode: full replay after this many
    #                              estimate-accepted moves (drift bound)
    time_budget_s: Optional[float] = None   # wall-clock cap on the proposal
    #                              loop (None: iterations/patience only) —
    #                              the benchmark's same-budget comparison
    host_place: bool = False     # heterogeneous co-execution: offer the
    #                              host/CPU pools as placement targets (the
    #                              ``host_place`` move plans deliberate CPU
    #                              residents for cold-tail experts)
    host_exec_factor: float = 12.0   # CPU service time as a multiple of the
    #                              trace's device exec constant (paper
    #                              Fig. 5: CPU is ~8-20x slower)

    def __post_init__(self):
        if self.iterations < 0 or self.patience <= 0:
            raise ValueError("iterations must be >= 0, patience > 0")
        if self.host_exec_factor <= 0:
            raise ValueError(f"host_exec_factor must be positive, "
                             f"got {self.host_exec_factor}")
        if self.replication < 0:
            raise ValueError(f"replication must be >= 0, "
                             f"got {self.replication}")
        if not 0.0 <= self.replica_fraction <= 1.0:
            raise ValueError(f"replica_fraction must be in [0, 1], "
                             f"got {self.replica_fraction}")
        if self.scoring not in ("delta", "full"):
            raise ValueError(f"scoring must be 'delta' or 'full', "
                             f"got {self.scoring!r}")
        if self.revalidate_every <= 0:
            raise ValueError(f"revalidate_every must be > 0, "
                             f"got {self.revalidate_every}")
        if self.time_budget_s is not None and self.time_budget_s <= 0:
            raise ValueError(f"time_budget_s must be positive, "
                             f"got {self.time_budget_s}")


@dataclasses.dataclass
class SearchResult:
    plan: PlacementPlan
    seed_cost: float             # replay cost of the greedy seed plan
    cost: float                  # replay cost of the returned plan (<= seed)
    proposed: int
    accepted: int
    fell_back: bool              # no move improved: the seed plan itself is
    #                              returned (pinned-equivalence fallback)
    scoring: str = "full"        # how proposals were scored
    full_replays: int = 0        # trace replays actually performed (delta
    #                              mode: anchor + revalidations; full mode:
    #                              seed + one per scored proposal)

    def snapshot(self) -> dict:
        return {"seed_cost_s": round(self.seed_cost, 6),
                "cost_s": round(self.cost, 6),
                "improvement": round(1.0 - self.cost / self.seed_cost, 4)
                if self.seed_cost > 0 else 0.0,
                "proposed": self.proposed,
                "accepted": self.accepted,
                "fell_back": self.fell_back,
                "scoring": self.scoring,
                "full_replays": self.full_replays,
                "plan": self.plan.snapshot()}


class _Mover:
    """Move proposals over an expert -> [pools] mapping (pure: every
    proposal returns a mutated copy; feasibility beyond free capacity is
    enforced by ``PlacementPlan.from_assignments`` at scoring time)."""

    def __init__(self, coe: "CoEModel", capacities: Mapping[str, int],
                 groups: List[str], weights: Mapping[str, int],
                 rng: np.random.RandomState, cfg: SearchConfig,
                 host_groups: Sequence[str] = ()):
        self.coe = coe
        self.capacities = capacities
        self.groups = groups
        self.host_groups = list(host_groups)
        self.weights = weights
        self.rng = rng
        self.cfg = cfg
        by_weight = sorted(coe.experts,
                           key=lambda e: (-weights.get(e, 0), e))
        self.hot = by_weight[:cfg.hot_pool]
        self.cold = by_weight[-cfg.hot_pool:]

    # ------------------------------------------------------------------ #
    def _free(self, assign: Mapping[str, List[str]]) -> Dict[str, int]:
        free = dict(self.capacities)
        for eid, pools in assign.items():
            for g in pools:
                free[g] = free.get(g, 0) - self.coe.spec(eid).mem_bytes
        return free

    def _pick(self, items: List):
        return items[self.rng.randint(len(items))] if items else None

    @staticmethod
    def _copy(assign: Mapping[str, List[str]]) -> Dict[str, List[str]]:
        return {e: list(p) for e, p in assign.items() if p}

    # ------------------------------------------------------------------ #
    def propose(self, assign: Mapping[str, List[str]]
                ) -> Optional[Dict[str, List[str]]]:
        moves = ["replicate", "replicate", "replace", "replace",
                 "replace", "drop_replica", "drop_cold", "migrate",
                 "swap", "place"]
        if self.host_groups:
            # appended only when host placement is on, so the RNG stream —
            # and therefore the whole search trajectory — is unchanged when
            # it is off
            moves.append("host_place")
        move = self._pick(moves)
        return getattr(self, "_" + move)(assign)

    def _replicate(self, assign):
        free = self._free(assign)
        cands = []
        for eid in self.hot:
            pools = assign.get(eid, ())
            if not pools or len(pools) > self.cfg.replication:
                continue
            mem = self.coe.spec(eid).mem_bytes
            for g in self.groups:
                if g not in pools and mem <= free[g]:
                    cands.append((eid, g))
        picked = self._pick(cands)
        if picked is None:
            return None
        eid, g = picked
        new = self._copy(assign)
        new[eid].append(g)
        return new

    def _drop_replica(self, assign):
        cands = [(eid, g) for eid, pools in assign.items()
                 for g in pools[1:] if g in self.groups]
        picked = self._pick(cands)
        if picked is None:
            return None
        eid, g = picked
        new = self._copy(assign)
        new[eid].remove(g)
        return new

    def _replace(self, assign):
        """Composite move for full pools: evict a colder single-copy
        resident of a pool AND give a hotter expert a copy there in one
        proposal — neither half alone improves strictly (dropping a
        zero-weight expert is cost-neutral, placing needs the space first),
        so greedy accept would plateau without it."""
        free = self._free(assign)
        w = self.weights
        by_group: Dict[str, List[str]] = {}
        for e, pools in assign.items():
            if len(pools) == 1 and pools[0] in self.groups:
                by_group.setdefault(pools[0], []).append(e)
        cands = []
        for eid in self.hot:
            pools = assign.get(eid, ())
            if pools and len(pools) > self.cfg.replication:
                continue
            mem = self.coe.spec(eid).mem_bytes
            for g in self.groups:
                if g in pools:
                    continue
                for victim in by_group.get(g, ()):
                    if victim == eid or w.get(victim, 0) >= w.get(eid, 0):
                        continue
                    if mem <= free[g] + self.coe.spec(victim).mem_bytes:
                        cands.append((eid, g, victim))
        picked = self._pick(cands)
        if picked is None:
            return None
        eid, g, victim = picked
        new = self._copy(assign)
        del new[victim]
        new.setdefault(eid, []).append(g)
        return new

    def _drop_cold(self, assign):
        """Drop a cold single-copy expert off its device pool entirely (it
        falls back to host/disk) — the move that lets hot replicas claim
        space the greedy sweep spent on the tail."""
        cands = [eid for eid in self.cold
                 if len(assign.get(eid, ())) == 1
                 and assign[eid][0] in self.groups]
        eid = self._pick(cands)
        if eid is None:
            return None
        new = self._copy(assign)
        del new[eid]
        return new

    def _migrate(self, assign):
        free = self._free(assign)
        placed = [eid for eid, pools in assign.items()
                  if any(g in self.groups for g in pools)]
        eid = self._pick(placed)
        if eid is None:
            return None
        src = self._pick([g for g in assign[eid] if g in self.groups])
        mem = self.coe.spec(eid).mem_bytes
        dsts = [g for g in self.groups
                if g != src and g not in assign[eid] and mem <= free[g]]
        dst = self._pick(dsts)
        if dst is None:
            return None
        new = self._copy(assign)
        new[eid][new[eid].index(src)] = dst
        return new

    def _swap(self, assign):
        singles = [eid for eid, pools in assign.items()
                   if len(pools) == 1 and pools[0] in self.groups]
        if len(singles) < 2:
            return None
        a = self._pick(singles)
        b = self._pick([e for e in singles if assign[e][0] != assign[a][0]])
        if b is None:
            return None
        new = self._copy(assign)
        new[a][0], new[b][0] = new[b][0], new[a][0]
        return new

    def _place(self, assign):
        free = self._free(assign)
        cands = []
        for eid, w in self.weights.items():
            if w <= 0 or assign.get(eid) or eid not in self.coe.experts:
                continue
            mem = self.coe.spec(eid).mem_bytes
            cands.extend((eid, g) for g in self.groups if mem <= free[g])
        picked = self._pick(cands)
        if picked is None:
            return None
        eid, g = picked
        new = self._copy(assign)
        new[eid] = [g]
        return new

    def _host_place(self, assign):
        """Deliberate CPU residents (heterogeneous co-execution): move a
        cold single-copy device-pool expert — or place an unplaced traced
        expert — onto a host/CPU pool, where it executes in place. Frees
        device bytes for hotter experts while the cold tail keeps serving
        without a disk reload."""
        free = self._free(assign)
        cands = []
        for eid in self.cold:
            if eid not in self.coe.experts:
                continue
            pools = assign.get(eid, ())
            if pools and (len(pools) != 1 or pools[0] not in self.groups):
                continue
            mem = self.coe.spec(eid).mem_bytes
            cands.extend((eid, g) for g in self.host_groups
                         if mem <= free[g])
        picked = self._pick(cands)
        if picked is None:
            return None
        eid, g = picked
        new = self._copy(assign)
        new[eid] = [g]
        return new


def search_placement(coe: "CoEModel", capacities: Mapping[str, int],
                     trace: WorkloadTrace, tier: TierSpec,
                     links: str = "shared",
                     pool_devices: Optional[Mapping[str, str]] = None,
                     seed_plan: Optional[PlacementPlan] = None,
                     config: Optional[SearchConfig] = None) -> SearchResult:
    """Local search over placements, seeded by (and never worse than) the
    greedy hot-first sweep.

    Starting from ``seed_plan`` (default: ``PlacementPlan.build`` with no
    replication — the paper's sweep), propose replicate / drop / migrate /
    swap / place moves; stop after ``config.patience`` consecutive rejects,
    ``config.iterations`` proposals, or ``config.time_budget_s`` wall
    seconds. With ``scoring='full'`` every proposal replays the whole trace
    and only strict improvements are kept. With ``scoring='delta'`` (the
    default) proposals are scored against a full-replay *anchor* by
    re-pricing only the moved experts' trace events; every
    ``revalidate_every`` estimate-accepts (and once at the end) a real
    replay re-anchors the search, and only plans a *full* replay verified
    as strictly better than the incumbent ever become the result — so the
    returned cost is always a true replay cost and never worse than the
    greedy seed. When nothing improves, the *original seed plan object* is
    returned (``fell_back``), so greedy-equivalence is exact, not
    approximate."""
    cfg = config or SearchConfig()
    if seed_plan is None:
        seed_plan = PlacementPlan.build(coe, capacities)
    groups = _device_groups(capacities, pool_devices)
    host_groups = _host_groups(capacities, pool_devices) \
        if cfg.host_place else []
    host_exec_s = cfg.host_exec_factor * trace.exec_s if host_groups else 0.0
    seed_assign = {e: list(seed_plan.pools_for(e))
                   for e in seed_plan.assignments}
    # a caller-supplied seed may already spend more replicas than the search
    # config allows; widen the limits so the seed itself stays feasible
    seed_snap = seed_plan.snapshot()
    repl_limit = max(cfg.replication, seed_plan.replication,
                     max((len(p) - 1 for p in seed_assign.values()),
                         default=0))
    frac_limit = cfg.replica_fraction
    for g, rb in seed_snap["replica_bytes"].items():
        cap = capacities.get(g, 0)
        if cap > 0 and rb > 0:
            frac_limit = max(frac_limit, min(1.0, (rb + 1) / cap))

    def materialize(assign) -> PlacementPlan:
        return PlacementPlan.from_assignments(
            coe, capacities, assign, replication=repl_limit,
            replica_fraction=frac_limit)

    def full_detail(plan) -> _ReplayDetail:
        return _replay(coe, capacities, plan, trace, tier, links=links,
                       pool_devices=pool_devices,
                       record=cfg.scoring == "delta",
                       host_groups=host_groups, host_exec_s=host_exec_s)

    state = {"full_replays": 1}
    seed_detail = full_detail(seed_plan)
    seed_cost = seed_detail.mean
    best_assign, best_cost, best_plan = seed_assign, seed_cost, seed_plan
    best_detail = seed_detail
    proposed = accepted = stale = 0
    deadline = None if cfg.time_budget_s is None \
        else _time.monotonic() + cfg.time_budget_s

    def out_of_budget(it: int) -> bool:
        if it >= cfg.iterations or stale >= cfg.patience:
            return True
        return deadline is not None and _time.monotonic() >= deadline

    if groups and trace.events:
        mover = _Mover(coe, capacities, groups, trace.weights(),
                       np.random.RandomState(cfg.seed), cfg,
                       host_groups=host_groups)
        if cfg.scoring == "full":
            it = 0
            while not out_of_budget(it):
                it += 1
                cand = mover.propose(best_assign)
                proposed += 1
                if cand is None:
                    stale += 1
                    continue
                try:
                    plan = materialize(cand)
                except ValueError:   # replica budget / capacity infeasible
                    stale += 1
                    continue
                cost = replay_cost(coe, capacities, plan, trace, tier,
                                   links=links, pool_devices=pool_devices,
                                   host_groups=host_groups,
                                   host_exec_s=host_exec_s)
                state["full_replays"] += 1
                if cost < best_cost - 1e-12:
                    best_assign, best_cost, best_plan = cand, cost, plan
                    accepted += 1
                    stale = 0
                else:
                    stale += 1
        else:
            scorer = _DeltaScorer(seed_detail, seed_assign)
            cur_assign, cur_est = seed_assign, seed_cost
            pending = 0     # estimate-accepts since the last revalidation

            def revalidate():
                """Full replay of the current assignment: adopt it as the
                incumbent iff strictly better, else rewind to the verified
                best; re-anchor the scorer either way."""
                nonlocal best_assign, best_cost, best_plan, best_detail
                nonlocal cur_assign, cur_est, scorer, pending
                plan = materialize(cur_assign)
                detail = full_detail(plan)
                state["full_replays"] += 1
                if detail.mean < best_cost - 1e-12:
                    best_assign, best_cost, best_plan = \
                        cur_assign, detail.mean, plan
                    best_detail = detail
                else:
                    cur_assign = best_assign
                    detail = best_detail
                scorer = _DeltaScorer(detail, cur_assign)
                cur_est = detail.mean
                pending = 0

            it = 0
            while not out_of_budget(it):
                it += 1
                cand = mover.propose(cur_assign)
                proposed += 1
                if cand is None:
                    stale += 1
                    continue
                try:
                    materialize(cand)    # feasibility gate only
                except ValueError:
                    stale += 1
                    continue
                est = scorer.estimate(cand)
                if est < cur_est - 1e-12:
                    cur_assign, cur_est = cand, est
                    accepted += 1
                    pending += 1
                    stale = 0
                    if pending >= cfg.revalidate_every:
                        revalidate()
                else:
                    stale += 1
            if pending:
                revalidate()
    return SearchResult(plan=best_plan, seed_cost=seed_cost, cost=best_cost,
                        proposed=proposed, accepted=accepted,
                        fell_back=best_plan is seed_plan,
                        scoring=cfg.scoring,
                        full_replays=state["full_replays"])
