"""Tier topology: the storage hierarchy as a first-class object (paper §2.2).

Source of truth: this module owns the *shape* of the hierarchy — which links
exist and who rides which one. Pricing lives in ``transfer.TransferEngine``;
per-expert residency lives in ``residency``; this module only declares the
graph.

A CoE catalog does not fit in device memory, so every expert lives somewhere
on a disk -> host DRAM -> device chain and serving is dominated by the
traffic between those tiers. ``TierSpec`` carries the per-device numbers
(bandwidths, fixed overheads, capacities); ``TierTopology`` instantiates the
transfer links between the tiers as a per-device graph with three channel
classes: one SSD link that every device fans in on, one PCIe-class
host->device channel per accelerator (``links="per-device"``) or one channel
shared by the whole fleet (``links="shared"``, the single-board layout), and
— when ``TierSpec.peer_bw > 0`` — one NVLink/ICI-class *peer* ingress link
per device pool, so a replica of an expert already resident on a sibling
device materializes via a pool -> pool copy at peer bandwidth instead of a
host-DRAM reload over PCIe. Every consumer — simulator, real engine,
scheduler predictions, profiler — sees the same graph instead of
re-deriving pieces of it.

UMA devices (the paper's Apple-M2-class board) collapse the middle tier:
there is no separate host cache and loads go disk -> unified memory over the
single storage link.

``Residency`` is the per-expert state machine the hierarchy tracks:

    DISK ──promote──> HOST ──load──> LOADING ──done──> DEVICE <──pin──> PINNED
      ^                 ^                                  │
      └── (never demoted past host) <──────evict───────────┘

On UMA the HOST state is skipped entirely.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Sequence

from repro_torch.memory.channels import TransferChannel

LINK_MODES = ("shared", "per-device")


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """Bandwidths in bytes/sec; fixed per-load overhead in seconds."""
    name: str
    disk_bw: float = 530e6           # paper NUMA: MICRON SSD 530 MB/s
    host_to_device_bw: float = 12e9  # PCIe-class host->HBM
    host_overhead: float = 0.010     # framework/layout overhead per load
    disk_overhead: float = 0.005
    unified: bool = False            # UMA: no separate host cache tier
    host_cache_bytes: int = 16 << 30
    device_bytes: int = 12 << 30
    peer_bw: float = 0.0             # device<->device (NVLink/ICI-class)
    #                                  pool->pool copy bandwidth; 0 = no peer
    #                                  fabric (the single-board presets)
    peer_overhead: float = 0.002     # fixed per-copy overhead on the fabric


NUMA = TierSpec(name="numa", disk_bw=530e6, host_to_device_bw=12e9,
                unified=False, host_cache_bytes=16 << 30, device_bytes=12 << 30)
UMA = TierSpec(name="uma", disk_bw=3000e6, host_to_device_bw=40e9,
               host_overhead=0.030,  # paper: >60% of latency even on UMA
               unified=True, host_cache_bytes=0, device_bytes=24 << 30)
TPU_V5E = TierSpec(name="tpu_v5e", disk_bw=2000e6, host_to_device_bw=16e9,
                   unified=False, host_cache_bytes=128 << 30,
                   device_bytes=16 << 30)


class Residency(enum.Enum):
    """Where one expert currently lives in the hierarchy."""
    DISK = "disk"          # only on persistent storage
    HOST = "host"          # promoted into host DRAM (or promotion in flight)
    LOADING = "loading"    # transfer into a device pool in flight
    DEVICE = "device"      # resident and ready in a device pool
    PINNED = "pinned"      # resident and currently executing (un-evictable)


@dataclasses.dataclass
class TierTopology:
    """The link graph of one physical storage hierarchy.

    ``disk_channel`` is the SSD link (disk -> host on NUMA, disk -> unified
    memory on UMA); every device pool fans in on it. ``pcie_channels`` are
    the host -> device links (unused on UMA), keyed by device-pool group:
    with ``links="shared"`` there is exactly one channel (the single-board
    layout — every executor queues on it), with ``links="per-device"`` each
    accelerator pool gets its own channel, so two devices can pull experts
    from host DRAM concurrently while still contending on the one SSD.
    ``peer_channels`` are the third channel class (present only when the
    tier declares ``peer_bw``): per-pool NVLink/ICI ingress links for
    device -> device replica copies, keyed by the *destination* pool group —
    concurrent copies into one device queue on its ingress port while
    different devices receive concurrently. Concurrent transfers on one
    channel queue instead of each pretending it has the link to itself.
    """
    spec: TierSpec
    disk_channel: TransferChannel
    pcie_channels: Dict[str, TransferChannel]
    links: str = "shared"
    peer_channels: Dict[str, TransferChannel] = dataclasses.field(
        default_factory=dict)
    # plain attribute, not a property: ``TierSpec`` is frozen, so whether a
    # peer fabric exists is fixed at construction — and the scheduler's
    # assignment-cost path reads it per executor probe
    has_peer: bool = dataclasses.field(init=False)

    SHARED_KEY = ""   # pcie_channels key of the fleet-wide link (shared mode)

    def __post_init__(self):
        self.has_peer = self.spec.peer_bw > 0 and not self.spec.unified

    @classmethod
    def from_spec(cls, spec: TierSpec, groups: Sequence[str] = (),
                  links: str = "shared") -> "TierTopology":
        if links not in LINK_MODES:
            raise ValueError(f"unknown link mode {links!r} "
                             f"(expected one of {LINK_MODES})")
        if links == "per-device":
            chans = {g: TransferChannel(f"{spec.name}/pcie[{g}]",
                                        spec.host_to_device_bw)
                     for g in groups}
        else:
            chans = {cls.SHARED_KEY: TransferChannel(
                f"{spec.name}/pcie", spec.host_to_device_bw)}
        return cls(
            spec=spec,
            disk_channel=TransferChannel(f"{spec.name}/ssd", spec.disk_bw),
            pcie_channels=chans,
            links=links,
        )

    def pcie_for(self, group: str = "") -> TransferChannel:
        """The host->device channel a load into ``group``'s pool rides.
        Shared mode: the one fleet-wide link regardless of group. Per-device:
        the group's own link (created on first use for late-added pools)."""
        if self.links != "per-device":
            return self.pcie_channels[self.SHARED_KEY]
        ch = self.pcie_channels.get(group)
        if ch is None:
            ch = TransferChannel(f"{self.spec.name}/pcie[{group}]",
                                 self.spec.host_to_device_bw)
            self.pcie_channels[group] = ch
        return ch

    def peer_for(self, group: str) -> TransferChannel:
        """The peer ingress link a pool->pool copy into ``group`` rides
        (created on first use, like late-added per-device PCIe links).
        Only meaningful when the tier declares ``peer_bw``."""
        if not self.has_peer:
            raise ValueError(
                f"tier {self.spec.name!r} declares no peer fabric "
                "(peer_bw == 0 or unified memory)")
        ch = self.peer_channels.get(group)
        if ch is None:
            ch = TransferChannel(f"{self.spec.name}/peer[{group}]",
                                 self.spec.peer_bw)
            self.peer_channels[group] = ch
        return ch

    @property
    def pcie_channel(self) -> TransferChannel:
        """Single-link view (seed compat): the shared channel, or — per-device
        mode — the first device's channel. Group-aware callers should use
        ``pcie_for``."""
        if not self.pcie_channels:
            return self.pcie_for(self.SHARED_KEY)
        return next(iter(self.pcie_channels.values()))

    @property
    def unified(self) -> bool:
        return self.spec.unified
