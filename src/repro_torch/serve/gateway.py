"""Online serving gateway: streaming front-end over the event-driven core.

Source of truth: the only composition point of the online subsystem — the
simulation hooks (admission, completion, per-stage telemetry, ticks) are
wired exactly once here, so there is one place where "what runs on an
online tick" is defined.

``OnlineGateway`` wires the pieces of the online subsystem around an existing
``CoServeSystem`` (either engine — ``SimEngine`` advances virtual time from
profiles, ``RealEngine`` advances it by measured wall time of real JAX
expert loads/forwards):

  arrivals   — a lazy Request generator feeds ``Simulation.set_source``
               (one pending arrival in memory, streams can be unbounded)
  telemetry  — completion hooks update streaming per-tenant/per-expert
               p50/p95/p99 + windowed throughput; a periodic tick samples
               queue depth and fleet size into a timeline
  slo        — tenant deadlines drive the scheduler's EDF priority hook
  admission  — optional load shedding on fresh arrivals
  autoscaler — optional control loop scaling executors on the tick
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.core.coe import Request
from repro_torch.core.serving import CoServeSystem, Metrics
from repro_torch.core.simulator import Simulation

from repro_torch.serve.admission import AdmissionController
from repro_torch.serve.arrivals import TenantSpec, multi_tenant_stream
from repro_torch.serve.autoscaler import Autoscaler
from repro_torch.serve.slo import SLOPolicy, deadline_priority
from repro_torch.serve.telemetry import TelemetryHub


@dataclasses.dataclass
class OnlineReport:
    """Everything an online run produces (offline Metrics + streaming view)."""
    metrics: Metrics
    telemetry: dict
    admission: Optional[dict]
    autoscaler: Optional[dict]
    timeline: list

    def to_json(self) -> dict:
        m = self.metrics
        return {
            "completed": m.completed,
            "shed": self.telemetry.get("shed", 0),
            "throughput": round(m.throughput, 3),
            "makespan_s": round(m.makespan, 3),
            "switches": m.switches,
            "latency_s": {"avg": round(m.avg_latency, 4),
                          "p50": round(m.p50_latency, 4),
                          "p95": round(m.p95_latency, 4),
                          "p99": round(m.p99_latency, 4)},
            "per_tenant": self.telemetry.get("per_tenant", {}),
            "per_expert": self.telemetry.get("per_expert", {}),
            "queue": self.telemetry.get("queue", {}),
            "slo_violation_rate": self.telemetry.get("violation_rate", 0.0),
            "admission": self.admission,
            "autoscaler": self.autoscaler,
            "timeline": self.timeline,
        }


class OnlineGateway:
    def __init__(self, system: CoServeSystem,
                 tenants: Sequence[TenantSpec],
                 admission: Optional[AdmissionController] = None,
                 autoscaler: Optional[Autoscaler] = None,
                 slo_priority: bool = True,
                 tick_interval: float = 0.5,
                 telemetry_window_s: float = 10.0):
        self.system = system
        self.tenants = list(tenants)
        self.slo = SLOPolicy.from_tenants(self.tenants)
        self.telemetry = TelemetryHub(slo_targets=self.slo.target_map(),
                                      window_s=telemetry_window_s)
        self.admission = admission
        self.autoscaler = autoscaler
        if autoscaler is not None and autoscaler.telemetry is None:
            autoscaler.telemetry = self.telemetry
        self.tick_interval = tick_interval
        if slo_priority:
            system.scheduler.priority_fn = deadline_priority
        self.sim = Simulation(system)

    # ------------------------------------------------------------------ #
    def _tick(self, sim: Simulation, now: float):
        self.telemetry.sample(now, self.system.queue_depth(),
                              len(self.system.live_executors()))
        if self.autoscaler is not None:
            self.autoscaler.step(sim, now)

    # ------------------------------------------------------------------ #
    def run(self, max_requests: Optional[int] = None,
            source: Optional[Iterable[Request]] = None) -> OnlineReport:
        """Serve ``max_requests`` from the tenant mix (or an explicit
        ``source`` generator, which may be finite) to completion, collecting
        telemetry."""
        if max_requests is None and source is None:
            raise ValueError(
                "run() needs max_requests or a finite source: the default "
                "tenant mix is an unbounded stream and would never return")
        if getattr(self, "_ran", False):
            raise RuntimeError(
                "OnlineGateway.run() is single-shot: the Simulation and "
                "telemetry accumulate state — build a fresh gateway (and "
                "system) per run")
        self._ran = True
        sim = self.sim
        hub = self.telemetry
        tracer = self.system.tracer

        def on_admit(s: Simulation, req: Request) -> bool:
            hub.on_arrival(req, s.now)
            if self.admission is not None and not self.admission(s, req):
                hub.on_shed(req, s.now)
                if tracer.enabled:
                    tracer.emit(s.now, "shed", "gateway", req.tenant,
                                request=req.id,
                                policy=self.admission.config.policy)
                return False
            if tracer.full:
                tracer.emit(s.now, "admit", "gateway", req.tenant,
                            request=req.id, expert=req.expert_id)
            return True

        def on_complete(s: Simulation, req: Request, now: float):
            hub.on_complete(req, now)

        def on_stage(s: Simulation, req: Request, expert_id: str, now: float):
            hub.on_stage(req, self.system.coe.spec(expert_id).arch, now)

        sim.admission = on_admit
        sim.on_complete = on_complete
        sim.on_stage = on_stage
        sim.add_ticker(self.tick_interval, self._tick, start=0.0)
        stream = source if source is not None \
            else multi_tenant_stream(self.tenants, max_requests)
        sim.set_source(stream)
        metrics = sim.run()
        snap = hub.snapshot(sim.now)
        snap["violation_rate"] = round(hub.violation_rate(), 4)
        return OnlineReport(
            metrics=metrics,
            telemetry=snap,
            admission=self.admission.stats() if self.admission else None,
            autoscaler=self.autoscaler.summary() if self.autoscaler else None,
            timeline=[dataclasses.asdict(p) for p in hub.timeline],
        )
