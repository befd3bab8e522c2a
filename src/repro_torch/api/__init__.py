"""The port's user-facing API: one declarative spec in, one serving system
out, with real experts on the CUDA card unless ``device="cpu"`` is asked for.

    from repro_torch.api import DeploymentSpec, Session, build_system

    spec = DeploymentSpec.load("examples/specs/sim.json")
    result = Session(spec).run()

``DeploymentSpec`` (api.spec) is the single serializable description of a
deployment; ``build_system`` (api.build) turns it into a wired
``CoServeSystem``; ``Session`` (api.session) runs it and produces metrics
and artifacts; ``save_trace``/``load_trace`` and ``save_plan``/``load_plan``
(api.artifacts) round-trip workload traces and placement plans.
``repro_torch.launch.serve`` is a thin CLI adapter over this package.
"""
from repro_torch.api.artifacts import (load_plan, load_trace, save_plan,
                                       save_trace)
from repro_torch.api.build import (POLICIES, BuildContext, build_catalog,
                                   build_context, build_layout,
                                   build_real_system, build_system,
                                   make_requests, make_tenants,
                                   resolve_policy, resolve_tier)
from repro_torch.api.session import Session
from repro_torch.api.spec import (BoardSection, DeploymentSpec, FleetSection,
                                  MemorySection, ModelSpec,
                                  ObservabilitySection, PolicySection,
                                  ServingSection, SpecError, TenantSection,
                                  WorkloadSection)

__all__ = [
    "BoardSection", "BuildContext", "DeploymentSpec", "FleetSection",
    "MemorySection", "ModelSpec", "ObservabilitySection", "POLICIES",
    "PolicySection", "Session",
    "ServingSection", "SpecError", "TenantSection", "WorkloadSection",
    "build_catalog", "build_context", "build_layout", "build_real_system",
    "build_system", "load_plan", "load_trace", "make_requests",
    "make_tenants", "resolve_policy", "resolve_tier", "save_plan",
    "save_trace",
]
