"""CoServe core: the paper's contribution (scheduling, expert management,
offline profiling, serving runtime) as a composable library. The storage
hierarchy itself (tiers, pools, transfer channels, cross-tier prefetch)
lives in ``repro_torch.memory``; the seed's names are re-exported here."""
from repro_torch.core.coe import CoEModel, ExpertSpec, Request, RoutingModule
from repro_torch.core.scheduler import (Group, RequestScheduler, SchedulerPolicy,
                                  max_executable_batch, split_batch)
from repro_torch.core.expert_manager import ExpertManager
from repro_torch.core.memory import (NUMA, TPU_V5E, UMA, HostCache, ModelPool,
                               TierSpec, load_latency)
from repro_torch.core.profiler import (ArchProfile, DeviceProfile,
                                 decay_window_search, find_max_batch,
                                 fit_latency_line, microbenchmark_arch,
                                 pool_split_from_expert_count)
from repro_torch.core.serving import (COSERVE, COSERVE_EM, COSERVE_EM_RA,
                                COSERVE_NONE, SAMBA, SAMBA_FIFO,
                                SAMBA_PARALLEL, CoServeSystem, ExecutorSpec,
                                Metrics, SystemPolicy, latency_percentiles)
from repro_torch.core.simulator import Simulation, run_real
from repro_torch.core.engines import HostStore, RealEngine, SimEngine
from repro_torch.core.reference import (ReferenceScheduler, apply_reference,
                                  reference_pending_time)
from repro_torch.memory import (MemoryHierarchy, PrefetchConfig, Residency,
                          TransferChannel, TransferEngine)

__all__ = [
    "CoEModel", "ExpertSpec", "Request", "RoutingModule",
    "Group", "RequestScheduler", "SchedulerPolicy", "max_executable_batch",
    "split_batch", "ExpertManager", "NUMA", "UMA", "TPU_V5E", "HostCache",
    "ModelPool", "TierSpec", "load_latency", "ArchProfile", "DeviceProfile",
    "decay_window_search", "find_max_batch", "fit_latency_line",
    "microbenchmark_arch", "pool_split_from_expert_count", "COSERVE",
    "COSERVE_EM", "COSERVE_EM_RA", "COSERVE_NONE", "SAMBA", "SAMBA_FIFO",
    "SAMBA_PARALLEL", "CoServeSystem", "ExecutorSpec", "Metrics",
    "SystemPolicy", "Simulation", "run_real", "HostStore", "RealEngine",
    "SimEngine", "latency_percentiles", "MemoryHierarchy", "PrefetchConfig",
    "Residency", "TransferChannel", "TransferEngine",
    "ReferenceScheduler", "apply_reference", "reference_pending_time",
]
