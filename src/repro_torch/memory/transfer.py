"""TransferEngine: the single source of truth for expert-switch cost.

Source of truth: this module is the ONLY load-latency formula in the system.
The seed computed load latency in three places (``core.memory.load_latency``,
``SimEngine.load_latency``, and the profiled values the real engine predicts
with) that could silently drift apart. Every path now goes through here:

  ``predicted_load_latency`` /  the closed-form uncontended cost — what the
  ``predicted_peer_copy_latency``  scheduler, work stealing, pending-time and
                               profiler use (decisions must not depend on
                               transient queue state);
  ``begin_device_load`` /      the *contended* cost — actual occupancy of the
  ``begin_host_load`` /        shared SSD / PCIe / peer channels, what the
  ``begin_host_promotion`` /   simulator charges a transfer when it really
  ``begin_peer_copy``          happens.

A transfer that finds its link busy queues behind the in-flight traffic, so
the simulated latency of a load is ``channel wait + service`` while its
predicted latency stays the service time alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.memory.channels import Transfer, TransferChannel
from repro_torch.memory.tiers import TierSpec, TierTopology
from repro_torch.obs.tracer import NULL_TRACER


def predicted_load_latency(spec: TierSpec, mem_bytes: int,
                           in_host_cache: bool) -> float:
    """Uncontended expert switch cost from its current tier into device
    memory (the paper's per-tier load-latency model, Fig. 4/5)."""
    if spec.unified or not in_host_cache:
        return spec.disk_overhead + spec.host_overhead + mem_bytes / spec.disk_bw \
            + (0.0 if spec.unified else mem_bytes / spec.host_to_device_bw)
    return spec.host_overhead + mem_bytes / spec.host_to_device_bw


def predicted_host_load_latency(spec: TierSpec, mem_bytes: int) -> float:
    """Uncontended disk -> host DRAM cost (CPU executors / promotions)."""
    return spec.disk_overhead + mem_bytes / spec.disk_bw


def predicted_peer_copy_latency(spec: TierSpec, mem_bytes: int) -> float:
    """Uncontended device -> device replica copy over the peer fabric."""
    if spec.peer_bw <= 0:
        raise ValueError(f"tier {spec.name!r} declares no peer fabric")
    return spec.peer_overhead + mem_bytes / spec.peer_bw


class TransferEngine:
    """Owns the shared channels of one ``TierTopology`` and prices every
    cross-tier movement on them."""

    def __init__(self, topology: TierTopology):
        self.topology = topology
        self.spec = topology.spec
        self.tracer = NULL_TRACER    # set by CoServeSystem when tracing
        # ``TierSpec`` is frozen, so every prediction is a pure function of
        # the byte count — memoized because the scheduler prices a load per
        # executor probe (128 probes per arrival at fleet scale)
        self._pred_memo: Dict[Tuple[int, bool], float] = {}
        self._peer_memo: Dict[int, float] = {}

    def _trace(self, ch: TransferChannel, leg: Transfer, mem_bytes: int,
               op: str, leg_name: str, label: str):
        """One ``xfer`` event per channel leg: the channel is the track,
        ``wait`` is the leg's time queued behind in-flight traffic."""
        self.tracer.emit(leg.start, "xfer", ch.name, label or op,
                         dur=leg.done - leg.start, op=op, leg=leg_name,
                         bytes=mem_bytes, wait=leg.wait)

    # --- predictions (uncontended, side-effect free) -------------------- #
    def predict(self, mem_bytes: int, in_host_cache: bool) -> float:
        key = (mem_bytes, in_host_cache)
        hit = self._pred_memo.get(key)
        if hit is None:
            hit = self._pred_memo[key] = predicted_load_latency(
                self.spec, mem_bytes, in_host_cache)
        return hit

    def predict_host(self, mem_bytes: int) -> float:
        return predicted_host_load_latency(self.spec, mem_bytes)

    def predict_peer(self, mem_bytes: int) -> float:
        hit = self._peer_memo.get(mem_bytes)
        if hit is None:
            hit = self._peer_memo[mem_bytes] = predicted_peer_copy_latency(
                self.spec, mem_bytes)
        return hit

    # --- contended transfers (occupy the shared links) ------------------ #
    def begin_device_load(self, now: float, mem_bytes: int,
                          in_host_cache: bool,
                          host_ready_at: float = 0.0,
                          group: str = "", label: str = "") -> Transfer:
        """Start moving an expert into device ``group``'s memory at ``now``.

        ``host_ready_at`` > now means a disk->host promotion of this expert
        is still in flight: the PCIe leg waits for it instead of re-reading
        the disk (the promotion already owns the SSD link). ``group`` selects
        the host->device channel (per-device link mode); the SSD fan-in is
        always shared.
        """
        t = self.spec
        traced = self.tracer.enabled
        if t.unified:
            # single unified-memory link: the whole load rides the SSD channel
            ch = self.topology.disk_channel
            leg = ch.begin(
                now, mem_bytes, overhead=t.disk_overhead + t.host_overhead)
            if traced:
                self._trace(ch, leg, mem_bytes, "device_load", "unified",
                            label)
            return leg
        pcie = self.topology.pcie_for(group)
        if in_host_cache:
            leg = pcie.begin(
                max(now, host_ready_at), mem_bytes, overhead=t.host_overhead)
            if traced:
                self._trace(pcie, leg, mem_bytes, "device_load", "pcie",
                            label)
            return Transfer(issued=now, start=leg.start, done=leg.done)
        # disk -> host -> device: the SSD leg then the PCIe leg, each
        # queueing on its own shared link
        disk_ch = self.topology.disk_channel
        disk_leg = disk_ch.begin(
            now, mem_bytes, overhead=t.disk_overhead)
        pcie_leg = pcie.begin(
            disk_leg.done, mem_bytes, overhead=t.host_overhead)
        if traced:
            self._trace(disk_ch, disk_leg, mem_bytes, "device_load", "disk",
                        label)
            self._trace(pcie, pcie_leg, mem_bytes, "device_load", "pcie",
                        label)
        return Transfer(issued=now, start=disk_leg.start, done=pcie_leg.done,
                        host_landed=disk_leg.done)

    def begin_host_load(self, now: float, mem_bytes: int,
                        label: str = "") -> Transfer:
        """Disk -> host DRAM on demand (CPU executors run from DRAM)."""
        ch = self.topology.disk_channel
        leg = ch.begin(now, mem_bytes, overhead=self.spec.disk_overhead)
        if self.tracer.enabled:
            self._trace(ch, leg, mem_bytes, "host_load", "disk", label)
        return leg

    def begin_host_promotion(self, now: float, mem_bytes: int,
                             label: str = "") -> Transfer:
        """Speculative disk -> host promotion (cross-tier prefetch)."""
        ch = self.topology.disk_channel
        leg = ch.begin(now, mem_bytes, overhead=self.spec.disk_overhead)
        if self.tracer.enabled:
            self._trace(ch, leg, mem_bytes, "promotion", "disk", label)
        return leg

    def begin_kv_offload(self, now: float, nbytes: int, group: str,
                         label: str = "") -> Transfer:
        """Device -> host spill of paged KV blocks: rides (and queues on)
        the group's host->device link in the reverse direction — the same
        contended channel expert loads ride, which is exactly why offloading
        idle KV competes with (and can defer) weight traffic."""
        ch = self.topology.disk_channel if self.spec.unified \
            else self.topology.pcie_for(group)
        leg = ch.begin(now, nbytes, overhead=self.spec.host_overhead)
        if self.tracer.enabled:
            self._trace(ch, leg, nbytes, "kv_offload", "pcie", label)
        return leg

    def begin_kv_reload(self, now: float, nbytes: int, group: str,
                        label: str = "") -> Transfer:
        """Host -> device reload of previously offloaded KV blocks: a batch
        whose KV was spilled pays this leg before its next decode step."""
        ch = self.topology.disk_channel if self.spec.unified \
            else self.topology.pcie_for(group)
        leg = ch.begin(now, nbytes, overhead=self.spec.host_overhead)
        if self.tracer.enabled:
            self._trace(ch, leg, nbytes, "kv_reload", "pcie", label)
        return leg

    def begin_peer_copy(self, now: float, mem_bytes: int,
                        group: str, label: str = "") -> Transfer:
        """Device -> device replica copy into ``group``'s pool over the peer
        fabric: rides (and queues on) the destination's peer ingress link
        only — neither the SSD fan-in nor any PCIe channel is touched, which
        is the whole point of materializing replicas pool -> pool."""
        ch = self.topology.peer_for(group)
        leg = ch.begin(now, mem_bytes, overhead=self.spec.peer_overhead)
        if self.tracer.enabled:
            self._trace(ch, leg, mem_bytes, "peer_copy", "peer", label)
        return leg

    # ------------------------------------------------------------------ #
    @staticmethod
    def _aggregate(per_link: dict) -> dict:
        agg = {"transfers": 0, "bytes_moved": 0,
               "busy_time_s": 0.0, "wait_time_s": 0.0}
        for snap in per_link.values():
            for k in agg:
                agg[k] += snap[k]
        agg["busy_time_s"] = round(agg["busy_time_s"], 6)
        agg["wait_time_s"] = round(agg["wait_time_s"], 6)
        return agg

    def snapshot(self) -> dict:
        """Per-link stats. ``disk_channel``/``pcie_channel`` keep the PR 2
        single-link keys (``pcie_channel`` aggregates across devices in
        per-device mode so existing bench trajectories stay comparable);
        ``pcie_channels``/``peer_channels`` break the host->device and
        device->device traffic out per link."""
        per_link = {ch.name: ch.snapshot()
                    for ch in self.topology.pcie_channels.values()}
        per_peer = {ch.name: ch.snapshot()
                    for ch in self.topology.peer_channels.values()}
        return {"disk_channel": self.topology.disk_channel.snapshot(),
                "pcie_channel": self._aggregate(per_link),
                "pcie_channels": per_link,
                "peer_channel": self._aggregate(per_peer),
                "peer_channels": per_peer,
                "links": self.topology.links}
