"""Session: run a built deployment and collect its results/artifacts.

The port's twin of ``repro.api.session``: what "run this spec" means for
each ``serving.mode`` x ``serving.engine`` combination (offline simulation,
real PyTorch execution, streaming online gateway), with the result dict of
each mode in the reference's schema. It binds the port's ``build_context``.

    spec = DeploymentSpec.load("deploy.json")
    sess = Session(spec)
    result = sess.run()          # the mode's result dict
    sess.metrics()               # the underlying Metrics object
    sess.save_trace("trace.json")   # observed traffic -> artifact
    sess.save_plan("plan.json")     # the placement actually served
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.api import artifacts
from repro_torch.api.build import (POLICIES, BuildContext, build_context,
                                   real_board_layout)
from repro_torch.api.spec import DeploymentSpec
from repro_torch.core.coe import Request
from repro_torch.core.serving import ExecutorSpec, Metrics
from repro_torch.core.simulator import Simulation, run_real
from repro_torch.fleet import trace_from_counts


class Session:
    """One deployment, built and ready to serve. Building is eager (the
    spec is the contract; errors surface at construction), running is
    single-shot — simulations and telemetry accumulate state, so build a
    fresh Session per run."""

    def __init__(self, spec: DeploymentSpec, placement=None, device="cuda"):
        """``placement`` overrides the spec's placement section with an
        explicit ``PlacementPlan`` object (benchmark suites score
        externally-searched plans through it). ``device`` is where a real
        system's experts run: the CUDA card unless the caller asks for
        ``"cpu"``."""
        self.spec = spec
        self.ctx: BuildContext = build_context(spec, placement=placement,
                                               device=device)
        self.system = self.ctx.system
        self._metrics: Optional[Metrics] = None
        self._pending: List[Request] = []
        self._ran = False

    # ------------------------------------------------------------------ #
    def submit(self, requests: List[Request]):
        """Queue an explicit offline workload instead of the spec's one
        (sim mode only — online modes generate their own streams)."""
        if self.spec.serving.mode == "online":
            raise ValueError(
                "submit() is for offline workloads; online mode streams "
                "arrivals from workload.tenants")
        self._pending.extend(requests)

    def metrics(self) -> Metrics:
        if self._metrics is None:
            raise RuntimeError("run() the session first")
        return self._metrics

    def snapshot(self) -> dict:
        """Memory/placement state: the finished run's snapshot once run()
        completed, the freshly-built system's otherwise."""
        if self._metrics is not None:
            return dict(self._metrics.memory)
        snap = self.system.hierarchy.snapshot()
        snap["placement"] = self.system.placement.snapshot()
        return snap

    # ------------------------------------------------------------------ #
    # artifacts
    # ------------------------------------------------------------------ #
    def save_trace(self, path: str, length: int = 512):
        """Dump the traffic this run observed (per-expert assignment
        counts) as a replayable WorkloadTrace — tomorrow's
        ``fleet.placement="search"`` + ``fleet.trace_path`` input."""
        if not self.system.expert_load:
            raise RuntimeError(
                "no observed load to dump — run() the session first")
        artifacts.save_trace(
            trace_from_counts(self.system.expert_load, length=length), path)

    def save_plan(self, path: str):
        """Dump the placement plan this system actually served (searched,
        loaded, or the greedy sweep) for ``fleet.placement="plan"`` reuse."""
        artifacts.save_plan(self.system.placement, path)

    def save_events(self, path: str) -> dict:
        """Export the flight recorder's ring buffer as Chrome trace JSON
        (Perfetto-loadable; see docs/observability.md). Needs
        ``observability.trace`` set to "summary" or "full"."""
        tracer = self.system.tracer
        if not tracer.enabled:
            raise RuntimeError(
                'no events recorded — set observability.trace to "summary" '
                'or "full" (or pass --trace-events on the CLI)')
        from repro_torch.obs.export import save_events
        return save_events(tracer, path, metrics=self._metrics)

    # ------------------------------------------------------------------ #
    # running
    # ------------------------------------------------------------------ #
    def run(self) -> dict:
        """Serve the spec's workload to completion; returns the mode's
        result dict (the schema the CLI prints)."""
        if self._ran:
            raise RuntimeError(
                "Session.run() is single-shot: the simulation and telemetry "
                "accumulate state — build a fresh Session per run")
        self._ran = True
        mode, engine = self.spec.serving.mode, self.spec.serving.engine
        if mode == "sim":
            out = self._run_sim()
        elif mode == "real":
            out = self._run_real()
        else:
            out = self._run_online_real() if engine == "real" \
                else self._run_online()
        if self.spec.observability.trace_path:
            self.save_events(self.spec.observability.trace_path)
        return out

    # ------------------------------------------------------------------ #
    def _effective_devices(self) -> int:
        """Single-assign baselines normalize to one device (build_layout)."""
        if POLICIES[self.spec.policy.name].assign == "single":
            return 1
        return self.spec.fleet.devices

    def _run_sim(self) -> dict:
        spec = self.spec
        sim = Simulation(self.system)
        sim.submit(self._pending if self._pending else self.ctx.requests)
        m = self._metrics = sim.run()
        boards = [spec.model.board] if spec.model.kind == "board" else \
            list(dict.fromkeys(t.board for t in spec.workload.tenants))
        out = {"mode": "sim", "board": "+".join(boards),
               "tier": self.ctx.tier.name,
               "policy": spec.policy.name,
               "devices": self._effective_devices(),
               "links": spec.fleet.links, "completed": m.completed,
               "throughput": round(m.throughput, 2), "switches": m.switches,
               "makespan_s": round(m.makespan, 2),
               "avg_latency_s": round(m.avg_latency, 4),
               "stall_s": round(m.stall_time, 3),
               "placement": m.memory.get("placement", {}),
               "pcie_links": {name: ch.get("wait_time_s")
                              for name, ch in m.memory.get(
                                  "channels", {}).get("pcie_channels",
                                                      {}).items()},
               "peer_links": {name: ch.get("wait_time_s")
                              for name, ch in m.memory.get(
                                  "channels", {}).get("peer_channels",
                                                      {}).items()},
               "host_prefetch": m.memory.get("prefetch", {})}
        if m.decode:
            out["decode"] = m.decode
        if self.ctx.search_report is not None:
            out["placement_search"] = self.ctx.search_report
        return out

    def _real_requests(self) -> List[Request]:
        """The real-mode request stream (seed semantics: RandomState(1))."""
        coe = self.ctx.coe
        rng = np.random.RandomState(1)
        n_components = sum(1 for e in coe.experts if e.startswith("cls"))
        needs_det, det_assign = real_board_layout(
            n_components, sum(1 for e in coe.experts if e.startswith("det")))
        reqs = []
        for i in range(self.spec.workload.requests):
            c = int(rng.randint(n_components))
            reqs.append(Request(
                id=i, expert_id=f"cls{c:03d}",
                data={"component": c, "x": rng.randn(64).astype(np.float32),
                      "needs_detection": bool(needs_det[c]),
                      "det_expert": int(det_assign[c])}))
        return reqs

    def _run_real(self) -> dict:
        reqs = self._pending if self._pending else self._real_requests()
        m = self._metrics = run_real(self.system, reqs)
        out = {"mode": "real", "policy": self.spec.policy.name,
               "completed": m.completed,
               "throughput": round(m.throughput, 2), "switches": m.switches,
               "makespan_s": round(m.makespan, 3)}
        if m.decode:
            out["decode"] = m.decode
        return out

    # ------------------------------------------------------------------ #
    def _gateway(self, tenants):
        from repro_torch.serve import (AdmissionConfig,
                                       AdmissionController, Autoscaler,
                                       AutoscalerConfig, OnlineGateway)

        spec = self.spec
        admission = None
        if spec.serving.admission != "none":
            mean_rate = sum(t.rate for t in tenants) / len(tenants)
            # the token bucket defaults its refill to the tenant mix's mean
            # per-tenant rate, so the policy actually bites under a burst
            bucket_rate = spec.serving.bucket_rate \
                if spec.serving.bucket_rate is not None else mean_rate
            admission = AdmissionController(AdmissionConfig(
                policy=spec.serving.admission,
                max_queue=spec.serving.max_queue,
                bucket_rate=bucket_rate,
                bucket_burst=spec.serving.bucket_burst))

        autoscaler = None
        single = POLICIES[spec.policy.name].assign == "single" \
            and spec.model.kind != "tiny"   # real engine: seed behaviour
        #                                     keeps the autoscaler wired
        fleet = len(self.system.executors)
        bounds = spec.serving.autoscale_bounds(fleet_size=fleet)
        # single-assign policies route everything to executor 0: scaling the
        # fleet could never receive work, so the autoscaler is disabled
        if bounds is not None and not single:
            if self.ctx.executor_specs is not None:
                scale_spec = self.ctx.executor_specs[0]
            else:   # tiny real system: rebuild the spec from executor 0
                ex0 = self.system.executors[0]
                scale_spec = ExecutorSpec("gpu", ex0.device_profile,
                                          ex0.batch_bytes, "gpu")
            autoscaler = Autoscaler(AutoscalerConfig(
                spec=scale_spec, min_executors=bounds[0],
                max_executors=bounds[1]))
        return OnlineGateway(self.system, tenants, admission=admission,
                             autoscaler=autoscaler,
                             slo_priority=spec.serving.slo_priority,
                             tick_interval=spec.serving.tick)

    def _run_online(self) -> dict:
        spec = self.spec
        tenants = self.ctx.tenants
        gw = self._gateway(tenants)
        self.report = gw.run(max_requests=spec.workload.requests)
        self._metrics = self.report.metrics
        out = {"mode": "online", "engine": "sim", "tier": self.ctx.tier.name,
               "policy": spec.policy.name,
               "devices": self._effective_devices(),
               "links": spec.fleet.links,
               "replication": spec.fleet.replication,
               "tenants": {t.name: {"board": t.board.name,
                                    "rate_rps": t.rate,
                                    "process": t.process,
                                    "slo_s": t.slo_seconds}
                           for t in tenants}}
        if self.ctx.search_report is not None:
            out["placement_search"] = self.ctx.search_report
        out.update(self.report.to_json())
        return out

    def _run_online_real(self) -> dict:
        """The online gateway over the RealEngine: actual expert loads and
        forwards on the device advance the clock by measured wall time. The
        tiny local CoE's source always draws components uniformly at random,
        so the tenant is served (and reported) as request_class="random"."""
        from repro_torch.serve import make_gaps

        spec = self.spec
        coe = self.ctx.coe
        tenant = dataclasses.replace(self.ctx.tenants[0],
                                     request_class="random")
        n_components = sum(1 for e in coe.experts if e.startswith("cls"))
        n_detection = sum(1 for e in coe.experts if e.startswith("det"))
        needs_det, det_assign = real_board_layout(n_components, n_detection)

        def source():
            rng = np.random.RandomState(tenant.seed)
            gaps = make_gaps(tenant.process, tenant.rate, rng)
            t = 0.0
            for i in range(spec.workload.requests):
                t += next(gaps)
                c = int(rng.randint(n_components))
                yield Request(
                    id=i, expert_id=f"cls{c:03d}", arrival_time=t,
                    task_id=tenant.name, tenant=tenant.name,
                    deadline=t + tenant.slo_seconds, root_arrival_time=t,
                    data={"component": c,
                          "x": rng.randn(64).astype(np.float32),
                          "needs_detection": bool(needs_det[c]),
                          "det_expert": int(det_assign[c])})

        gw = self._gateway([tenant])
        self.report = gw.run(source=source())
        self._metrics = self.report.metrics
        out = {"mode": "online", "engine": "real",
               "policy": spec.policy.name,
               "tenants": {tenant.name: {"rate_rps": tenant.rate,
                                         "process": tenant.process,
                                         "request_class":
                                             tenant.request_class,
                                         "slo_s": tenant.slo_seconds}}}
        out.update(self.report.to_json())
        return out
