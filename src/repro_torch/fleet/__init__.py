"""Device-fleet topology subsystem: per-device links + explicit placement.

Source of truth for the fleet-level *shape* (how many devices, who shares a
pool) and for *placement policy* (where experts live, greedy or searched).

Extends the single-link, implicit-placement reproduction to multi-device
fleets (ROADMAP "multi-device fleets" open item; SN40L-style composition of
experts across sockets):

  ``FleetSpec`` / ``build_fleet``   N accelerators x executors-per-device,
                                    shared or per-device host->device links
  ``PlacementPlan``                 expert -> device-pool assignment and
                                    replication as a queryable object
  ``search_placement`` /            cost-model placement search: candidate
  ``WorkloadTrace`` /               plans scored by replaying a workload
  ``replay_cost``                   trace through the residency-aware
                                    ``MemoryHierarchy.assignment_cost``
  ``validate_pool_groups``          one pool group == one device kind

The links themselves live in ``repro_torch.memory.tiers.TierTopology`` (per-group
PCIe channels, shared SSD fan-in, per-pool peer ingress links); this package
owns the fleet-level shape and placement decisions on top of them.
"""
from repro_torch.fleet.placement import PlacementPlan
from repro_torch.fleet.search import (SearchConfig, SearchResult, WorkloadTrace,
                                replay_cost, search_placement,
                                trace_from_counts, trace_from_requests,
                                trace_from_usage)
from repro_torch.fleet.topology import (FleetSpec, build_fleet, device_group_name,
                                  validate_pool_groups)

__all__ = ["PlacementPlan", "FleetSpec", "build_fleet", "device_group_name",
           "validate_pool_groups", "SearchConfig", "SearchResult",
           "WorkloadTrace", "replay_cost", "search_placement",
           "trace_from_counts", "trace_from_requests", "trace_from_usage"]
