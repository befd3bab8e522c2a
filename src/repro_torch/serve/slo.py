"""Per-tenant SLO targets and deadline-aware scheduling priority.

Source of truth: the only mapping from tenant to latency target —
violation classification (TelemetryHub) and EDF queue priority both read
the targets from here, so "violates its SLO" has one definition.

An SLO is an end-to-end latency target per tenant (``TenantSpec.slo_seconds``
stamps each request's absolute ``deadline`` at generation time). Two
consumers:

  * ``deadline_priority`` plugs into ``RequestScheduler.priority_fn`` —
    new queue groups are inserted earliest-deadline-first, so a tight-SLO
    tenant's work overtakes slack work *without* breaking the paper's
    arranging (same-expert requests still merge into one group; the group
    carries its earliest member deadline).
  * ``SLOPolicy.target_map`` hands the tenant -> target map to
    ``TelemetryHub``, which owns violation classification (one definition).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

from repro_torch.core.coe import Request

_FAR_FUTURE = 1e30   # deadline for requests with no SLO: never overtakes


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    tenant: str
    latency_s: float            # end-to-end target


def deadline_priority(req: Request) -> float:
    """Scheduler hook: absolute deadline (earlier = more urgent)."""
    return req.deadline if req.deadline is not None else _FAR_FUTURE


@dataclasses.dataclass
class SLOPolicy:
    """The tenant -> target map used by telemetry, admission and scaling."""
    targets: Dict[str, SLOTarget]

    @classmethod
    def from_tenants(cls, tenants: Sequence) -> "SLOPolicy":
        return cls(targets={t.name: SLOTarget(t.name, t.slo_seconds)
                            for t in tenants})

    def target_map(self) -> Dict[str, float]:
        return {name: t.latency_s for name, t in self.targets.items()}
