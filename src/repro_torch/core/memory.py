"""Compatibility shim: the memory model now lives in ``repro_torch.memory``.

The tier specs, pools and latency math that used to be defined here were
extracted into the unified tiered-memory subsystem (``repro_torch.memory``:
topology + shared transfer channels + per-tier residency + cross-tier
prefetch). This module keeps the seed's import surface working:

  ``ModelPool``  -> ``repro_torch.memory.DevicePool``
  ``HostCache``  -> ``repro_torch.memory.HostTier``
  ``load_latency(spec, mem_bytes, in_host_cache)``
                 -> ``repro_torch.memory.transfer.predicted_load_latency``
"""
from __future__ import annotations

from repro_torch.memory.residency import DevicePool, HostTier
from repro_torch.memory.tiers import NUMA, TPU_V5E, UMA, Residency, TierSpec
from repro_torch.memory.transfer import predicted_load_latency as load_latency

# seed names
ModelPool = DevicePool
HostCache = HostTier

__all__ = ["ModelPool", "HostCache", "DevicePool", "HostTier", "TierSpec",
           "NUMA", "UMA", "TPU_V5E", "Residency", "load_latency"]
