"""Unified tiered-memory subsystem: disk -> host DRAM -> device residency.

The hierarchy the whole system reports against (paper §2.2, §4.3–4.4):

  ``TierSpec`` / ``TierTopology``   device numbers + the link graph (shared
                                    SSD fan-in, per-device or shared PCIe)
  ``TransferChannel``               one contended link (FIFO bandwidth sharing)
  ``TransferEngine``                the single load-latency source of truth
  ``DevicePool`` / ``HostTier``     per-tier residency with pluggable eviction
  ``Residency``                     DISK/HOST/LOADING/DEVICE/PINNED states
  ``CrossTierPrefetcher``           dependency-aware disk->host promotion
  ``MemoryHierarchy``               the facade CoServeSystem owns
"""
from repro_torch.memory.channels import Transfer, TransferChannel
from repro_torch.memory.hierarchy import MemoryHierarchy
from repro_torch.memory.policies import (POLICY_NAMES, EvictionPolicy, EvictionView,
                                   make_policy)
from repro_torch.memory.prefetch import CrossTierPrefetcher, PrefetchConfig
from repro_torch.memory.residency import DevicePool, HostTier, ReadySet, StateEpoch
from repro_torch.memory.tiers import (LINK_MODES, NUMA, TPU_V5E, UMA, Residency,
                                TierSpec, TierTopology)
from repro_torch.memory.transfer import (TransferEngine, predicted_host_load_latency,
                                   predicted_load_latency)

__all__ = [
    "LINK_MODES", "Transfer", "TransferChannel", "MemoryHierarchy",
    "POLICY_NAMES",
    "EvictionPolicy", "EvictionView", "make_policy", "CrossTierPrefetcher",
    "PrefetchConfig", "DevicePool", "HostTier", "ReadySet", "StateEpoch",
    "NUMA", "TPU_V5E", "UMA",
    "Residency", "TierSpec", "TierTopology", "TransferEngine",
    "predicted_host_load_latency", "predicted_load_latency",
]
