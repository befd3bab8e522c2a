"""Device-fleet topology: how many accelerators, and who owns which link.

Source of truth: the only builder of multi-device (pools, executor specs)
shapes, and the only validator of the one-pool-one-device-kind invariant
(``validate_pool_groups``) — construction-time and runtime scale-ups both
go through it.

One physical system (paper §5.1) is a single accelerator behind one SSD and
one PCIe link; a *fleet* is N accelerators that each own a device-memory
pool and a host->device channel while fanning in on the shared SSD.
``FleetSpec`` describes that shape declaratively; ``build_fleet`` turns it
into the (pools, executor specs) pair ``CoServeSystem`` consumes, with the
single-device case reproducing ``workload.make_executor_specs`` exactly so
the paper-reproduction trajectory is unchanged.

``validate_pool_groups`` is the spec-level guard: two executor specs with
conflicting ``device`` kinds must not share one pool group — a pool is one
physical device's memory, and mixing (say) a CPU executor's DRAM pool with
a GPU executor's HBM pool would silently merge two different latency models
into one residency set.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.memory.tiers import LINK_MODES, TierSpec


def device_group_name(index: int, n_devices: int, kind: str = "gpu") -> str:
    """Pool-group name of accelerator ``index``: the seed's bare ``gpu`` for
    a single device (compat), ``gpu0``/``gpu1``/... for a fleet."""
    return kind if n_devices == 1 else f"{kind}{index}"


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Shape of one serving fleet.

    ``gpu_per_device`` executors run on each of ``n_devices`` accelerators
    (the paper's 3-executors-on-one-GPU layout, per device); ``n_cpu``
    host-side executors run from DRAM. ``links`` picks the host->device
    channel layout: ``shared`` (one PCIe link the whole fleet queues on —
    the PR 2 baseline) or ``per-device`` (one link per accelerator).
    Expert replication is a *placement* decision, not a fleet-shape one —
    pass it to ``CoServeSystem``/``PlacementPlan.build``.
    """
    n_devices: int = 1
    gpu_per_device: int = 3
    n_cpu: int = 1
    links: str = "shared"

    def __post_init__(self):
        if self.n_devices < 1:
            raise ValueError(f"fleet needs >= 1 device, got {self.n_devices}")
        if self.gpu_per_device < 0 or self.n_cpu < 0:
            raise ValueError("executor counts must be >= 0")
        if self.links not in LINK_MODES:
            raise ValueError(f"unknown link mode {self.links!r} "
                             f"(expected one of {LINK_MODES})")

    def device_groups(self) -> List[str]:
        return [device_group_name(i, self.n_devices)
                for i in range(self.n_devices)]


def build_fleet(tier: TierSpec, fleet: FleetSpec,
                pool_fraction: float = 0.75,
                gpu_pool_bytes: Optional[int] = None,
                cpu_multiplier: float = 0.0
                ) -> Tuple[Dict[str, int], list]:
    """(pools, executor specs) for a fleet on ``tier``-class devices.

    Each accelerator owns ``tier.device_bytes`` of memory split pool/batch by
    ``pool_fraction`` (batch region divided between that device's
    executors); CPU executors share half the host DRAM as in the seed. For
    ``n_devices == 1`` the output is identical to
    ``workload.make_executor_specs(tier, gpu_per_device, n_cpu)``.
    ``cpu_multiplier`` > 0 derives the CPU service-time model from the
    device time instead of the static constants (``hetero.cpu_multiplier``).
    """
    # lazy: workload imports repro_torch.core.serving, which imports repro_torch.fleet
    from repro_torch.core.serving import ExecutorSpec
    from repro_torch.core.workload import device_profile

    pools: Dict[str, int] = {}
    specs: List[ExecutorSpec] = []
    n_gpu_total = fleet.n_devices * fleet.gpu_per_device
    gpu_prof = device_profile("gpu", tier, cpu_multiplier)
    cpu_prof = device_profile("cpu", tier, cpu_multiplier)

    if tier.unified:
        # one unified memory region split between device- and host-side
        # executors (seed semantics), then carved per accelerator
        gpu_region_total = tier.device_bytes * n_gpu_total \
            // max(1, n_gpu_total + fleet.n_cpu)
        cpu_region = tier.device_bytes - gpu_region_total
        gpu_region = gpu_region_total // max(1, fleet.n_devices)
    else:
        gpu_region = tier.device_bytes        # each device has its own HBM
        cpu_region = tier.host_cache_bytes // 2

    if fleet.gpu_per_device:
        for d in range(fleet.n_devices):
            group = device_group_name(d, fleet.n_devices)
            pool = gpu_pool_bytes if gpu_pool_bytes is not None \
                else int(gpu_region * pool_fraction)
            pools[group] = pool
            batch_each = (gpu_region - pool) // fleet.gpu_per_device
            for _ in range(fleet.gpu_per_device):
                specs.append(ExecutorSpec("gpu", gpu_prof, batch_each, group))
    if fleet.n_cpu:
        pool = int(cpu_region * pool_fraction)
        pools["cpu"] = pool
        batch_each = (cpu_region - pool) // fleet.n_cpu
        for _ in range(fleet.n_cpu):
            specs.append(ExecutorSpec("cpu", cpu_prof, batch_each, "cpu"))
    return pools, specs


def validate_pool_groups(executor_specs: Sequence,
                         membership: Optional[Dict[str, str]] = None
                         ) -> Dict[str, str]:
    """Map pool group -> device kind, rejecting conflicting co-tenants.

    A pool group is one physical device's memory: every executor spec mapped
    onto it must declare the same ``device`` kind. Returns the (new or
    extended copy of ``membership``) map, surfaced in
    ``Metrics.memory['pool_devices']`` — ``add_executor`` passes the current
    membership so runtime scale-ups share the same invariant.
    """
    membership = dict(membership or {})
    for spec in executor_specs:
        group = spec.pool_group or spec.device
        seen = membership.get(group)
        if seen is None:
            membership[group] = spec.device
        elif seen != spec.device:
            raise ValueError(
                f"pool group {group!r} maps executors with conflicting "
                f"device kinds {seen!r} and {spec.device!r} — one pool is "
                "one physical device's memory")
    return membership
