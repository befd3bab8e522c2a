"""PlacementPlan: expert -> device-pool assignment as a first-class object.

Source of truth: the only record of where each expert is *supposed* to
live and how many planned copies it has — pools hold what the plan says
(modulo runtime eviction), and every byte-accounting question about
placement (per-pool planned/replica budgets) is answered here.

The seed decided initial expert placement inside a loop in
``CoServeSystem._initial_placement`` — round-robin over pools by descending
usage probability — and then forgot the decision: nothing could ask "where
is expert X *supposed* to live", replication was impossible, and a scale
event could only re-divide batch memory. SambaNova's SN40L composes experts
across many sockets and the QoS-Efficient Multi-MoE work partially
reconfigures expert placement across devices at runtime; both need placement
to be an explicit, queryable object. ``PlacementPlan`` is that object:

  base assignment   the paper's §4.1 round-robin-by-usage sweep, recorded
                    per expert instead of executed and discarded;
  replication       during the same hot-first sweep, an expert also gets up
                    to ``replication`` planned copies on other pools, drawn
                    from a bounded per-pool replica budget
                    (``replica_fraction`` of capacity) — hot experts claim
                    replica slots *before* cold experts claim primaries, so
                    several devices can serve the head of the distribution
                    switch-free while the tail still spills to host/disk;
  rebalance         scale events re-run the replication pass with pools
                    weighted by live executor count (hot pools first), so
                    placement follows the fleet instead of staying frozen
                    at construction.

The plan never exceeds a pool's byte capacity (planned bytes are accounted
exactly), and it is engine-independent: ``CoServeSystem`` applies it with
warm loads at init and the autoscaler applies rebalance deltas through the
normal contended load path.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Mapping, Optional, Sequence, \
    Tuple

if TYPE_CHECKING:  # pragma: no cover — core imports this package
    from repro_torch.core.coe import CoEModel


class PlacementPlan:
    """Explicit expert -> device-pool assignment with bounded replication."""

    def __init__(self, coe: "CoEModel", capacities: Mapping[str, int],
                 replication: int = 0, replica_fraction: float = 0.10):
        if replication < 0:
            raise ValueError(f"replication must be >= 0, got {replication}")
        if not 0.0 <= replica_fraction <= 1.0:
            raise ValueError(f"replica_fraction must be in [0, 1], "
                             f"got {replica_fraction}")
        self.coe = coe
        self.capacities: Dict[str, int] = dict(capacities)
        self.replication = replication
        self.replica_fraction = replica_fraction
        # expert -> pools holding a planned copy; first entry is the base
        # (primary) assignment, the rest are replicas
        self.assignments: Dict[str, List[str]] = {}
        self._planned_bytes: Dict[str, int] = {g: 0 for g in self.capacities}
        self._replica_bytes: Dict[str, int] = {g: 0 for g in self.capacities}
        # (expert, pool) in planned load order — hottest first, so applying
        # the plan warms pools deterministically
        self._layout: List[Tuple[str, str]] = []
        self.rebalances = 0

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #
    @classmethod
    def build(cls, coe: "CoEModel", capacities: Mapping[str, int],
              replication: int = 0, replica_fraction: float = 0.10,
              pool_order: Optional[List[str]] = None) -> "PlacementPlan":
        """One hot-first sweep: each expert's primary goes round-robin
        first-fit (bit-identical to the seed's ``_initial_placement`` loop
        when ``replication == 0``), and — with replication on — up to
        ``replication`` copies land on *other* pools out of each pool's
        bounded replica budget, so the head of the usage distribution claims
        its replica slots before the tail claims primaries."""
        plan = cls(coe, capacities, replication, replica_fraction)
        pools = pool_order if pool_order is not None else list(capacities)
        if pools:
            i = 0
            for spec in coe.by_usage():
                primary = None
                for j in range(len(pools)):
                    g = pools[(i + j) % len(pools)]
                    if spec.mem_bytes <= plan.free_planned(g):
                        plan._place(spec.id, g)
                        primary = g
                        i = (i + j + 1) % len(pools)
                        break
                # pools full / expert too large: stays on lower tiers
                if primary is not None and replication:
                    plan._replicate_one(spec, pools)
        return plan

    @classmethod
    def from_assignments(cls, coe: "CoEModel", capacities: Mapping[str, int],
                         assignments: Mapping[str, Sequence[str]],
                         replication: int = 0,
                         replica_fraction: float = 0.10) -> "PlacementPlan":
        """Materialize an explicit expert -> pools mapping (e.g. a searched
        plan) as a validated ``PlacementPlan``. The first pool of each
        expert's list is its primary; the rest are replicas. Layout order is
        hottest-first (``coe.by_usage``), matching the greedy sweep's warm
        order. Raises ``ValueError`` when the mapping overflows a pool, puts
        two copies on one pool, exceeds ``replication`` copies beyond the
        primary, or blows a pool's replica budget
        (``replica_fraction`` x capacity) — the invariants the seeded-random
        tests pin."""
        plan = cls(coe, capacities, replication, replica_fraction)
        unknown = [e for e, pools in assignments.items()
                   if pools and e not in coe.experts]
        if unknown:
            raise ValueError(
                f"assignments name experts not in the catalog: {unknown}")
        known = set(plan.capacities)
        for spec in coe.by_usage():
            pools = assignments.get(spec.id) or ()
            for i, g in enumerate(pools):
                if g not in known:
                    raise ValueError(
                        f"assignment of {spec.id!r} names unknown pool {g!r}")
                if i > 0 and spec.mem_bytes > plan._replica_budget(g):
                    raise ValueError(
                        f"replica of {spec.id!r} overflows pool {g!r}'s "
                        f"replica budget ({replica_fraction:.0%} of capacity)")
                plan._place(spec.id, g, replica=i > 0)
            if len(pools) > 1 + replication:
                raise ValueError(
                    f"{spec.id!r} plans {len(pools) - 1} replicas, "
                    f"replication allows {replication}")
        plan.validate()
        return plan

    def _place(self, expert_id: str, group: str, replica: bool = False):
        self.assignments.setdefault(expert_id, []).append(group)
        self._planned_bytes[group] = self._planned_bytes.get(group, 0) \
            + self.coe.spec(expert_id).mem_bytes
        if replica:
            self._replica_bytes[group] = self._replica_bytes.get(group, 0) \
                + self.coe.spec(expert_id).mem_bytes
        self._layout.append((expert_id, group))

    def _replica_budget(self, group: str) -> int:
        """Bytes still available for replicas on ``group``: replicas may
        claim at most ``replica_fraction`` of the pool, so they sharpen the
        head of the distribution without crowding out primaries wholesale."""
        cap = int(self.capacities.get(group, 0) * self.replica_fraction)
        return cap - self._replica_bytes.get(group, 0)

    def _replicate_one(self, spec, pool_order: List[str]):
        """Plan up to ``replication`` extra copies of one expert on pools it
        is not on yet, within each pool's replica budget. Re-runnable:
        existing copies are kept."""
        placed = self.assignments.get(spec.id)
        if not placed:
            return                     # never replicate what never fit
        want = min(self.replication, len(pool_order) - 1)
        for g in pool_order:
            if len(placed) >= 1 + want:
                break
            if g in placed:
                continue
            if spec.mem_bytes <= self.free_planned(g) \
                    and spec.mem_bytes <= self._replica_budget(g):
                self._place(spec.id, g, replica=True)

    # ------------------------------------------------------------------ #
    # queries
    # ------------------------------------------------------------------ #
    def pools_for(self, expert_id: str) -> Tuple[str, ...]:
        """Every pool planned to hold a copy (empty: lower tiers only)."""
        return tuple(self.assignments.get(expert_id, ()))

    def primary_pool(self, expert_id: str) -> Optional[str]:
        pools = self.assignments.get(expert_id)
        return pools[0] if pools else None

    def replica_count(self, expert_id: str) -> int:
        """Planned copies beyond the primary."""
        return max(0, len(self.assignments.get(expert_id, ())) - 1)

    def planned(self, group: str) -> List[str]:
        """Experts planned onto ``group``, hottest (base sweep order) first."""
        return [eid for eid, g in self._layout if g == group]

    def planned_bytes(self, group: str) -> int:
        return self._planned_bytes.get(group, 0)

    def free_planned(self, group: str) -> int:
        return self.capacities.get(group, 0) - self._planned_bytes.get(group, 0)

    def layout(self) -> List[Tuple[str, str]]:
        """(expert, pool) pairs in planned load order."""
        return list(self._layout)

    # ------------------------------------------------------------------ #
    # artifact serialization (repro_torch.api.artifacts wraps file io)
    # ------------------------------------------------------------------ #
    def to_dict(self) -> dict:
        """Lossless JSON-ready form. ``from_dict`` rebuilds an equivalent
        plan (same assignments, layout order, budgets) against the same
        catalog — the capacities are stored so a reload onto a different
        fleet shape fails loudly instead of silently misplacing."""
        return {"replication": self.replication,
                "replica_fraction": self.replica_fraction,
                "capacities": dict(self.capacities),
                "assignments": {e: list(p)
                                for e, p in self.assignments.items()}}

    @classmethod
    def from_dict(cls, coe: "CoEModel", d: Mapping,
                  capacities: Optional[Mapping[str, int]] = None
                  ) -> "PlacementPlan":
        """Rebuild a saved plan against ``coe``. ``capacities`` (e.g. the
        pools of the system about to apply the plan) must match the saved
        pool shape byte for byte — a plan searched for one fleet is not
        valid on another."""
        for key in ("capacities", "assignments"):
            if key not in d:
                raise ValueError(
                    f"placement plan dict is missing {key!r} "
                    f"(got keys {sorted(d)})")
        saved = {str(g): int(b) for g, b in d["capacities"].items()}
        if capacities is not None and dict(capacities) != saved:
            raise ValueError(
                "saved placement plan was built for pools "
                f"{saved} but the target fleet has {dict(capacities)} — "
                "re-run the placement search for this fleet shape")
        return cls.from_assignments(
            coe, saved, {str(e): list(p) for e, p in d["assignments"].items()},
            replication=int(d.get("replication", 0)),
            replica_fraction=float(d.get("replica_fraction", 0.10)))

    # ------------------------------------------------------------------ #
    # runtime reconfiguration
    # ------------------------------------------------------------------ #
    def rebalance(self, pool_weights: Mapping[str, float],
                  expert_weights: Optional[Mapping[str, float]] = None
                  ) -> List[Tuple[str, str]]:
        """Re-run the replication pass with pools ordered hottest-first by
        ``pool_weights`` (e.g. live executors per pool after a scale event).
        ``expert_weights`` (e.g. observed per-expert assignment counts from
        the online path) re-ranks which experts claim replica slots first;
        without it the static pre-assessed P(use) order is used. Base
        assignments are kept — moving primaries would invalidate warm state
        for no modeled gain — only replicas are (re)planned. Returns the
        newly planned (expert, pool) copies."""
        self.rebalances += 1
        if not self.replication:
            return []
        order = sorted(self.capacities,
                       key=lambda g: (-pool_weights.get(g, 0.0), g))
        if expert_weights:
            specs = sorted(self.coe.experts.values(),
                           key=lambda e: (-expert_weights.get(e.id, 0.0),
                                          -e.usage_prob, e.id))
        else:
            specs = self.coe.by_usage()
        before = len(self._layout)
        for spec in specs:
            self._replicate_one(spec, order)
        return self._layout[before:]

    # ------------------------------------------------------------------ #
    def validate(self):
        """Planned bytes must fit every pool; replicas must be distinct."""
        for g, used in self._planned_bytes.items():
            cap = self.capacities.get(g, 0)
            if used > cap:
                raise ValueError(
                    f"placement plan overflows pool {g!r}: {used} > {cap}")
        for eid, pools in self.assignments.items():
            if len(set(pools)) != len(pools):
                raise ValueError(f"duplicate replica pools for {eid}: {pools}")

    def snapshot(self) -> dict:
        replicas = sum(self.replica_count(e) for e in self.assignments)
        return {
            "replication": self.replication,
            "placed": len(self.assignments),
            "replicas": replicas,
            "rebalances": self.rebalances,
            "planned_bytes": dict(self._planned_bytes),
            "replica_bytes": dict(self._replica_bytes),
        }
