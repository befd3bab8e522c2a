"""Shared transfer channels with bandwidth contention.

Source of truth: the only model of link occupancy — every contended
completion time in the system comes from ``TransferChannel.begin``, and
every backlog query reads ``busy_until`` here; no other code may track who
owns a link.

The seed modeled every executor's load path as a private link: N executors
could each stream an expert off the *same* SSD at full bandwidth. A
``TransferChannel`` is the corrected model: one physical link (SSD, PCIe)
that concurrent transfers must share. Transfers are serialized FIFO — a
transfer issued while the link is busy starts when the link frees, so two
same-instant loads finish in ~2x the time of one (the paper's §2.2
observation that switch traffic, not compute, is the bottleneck).

FIFO serialization (rather than processor-sharing) keeps completion times
final at issue time, which the event-driven simulator needs: a pushed
LOAD_DONE event never has to be re-scheduled, and per-link throughput is
identical to fair sharing for equal-size transfers.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Transfer:
    """One scheduled (possibly multi-leg) movement across the hierarchy."""
    issued: float         # when the transfer was requested
    start: float          # when a link first begins serving it
    done: float           # when the transfer completes
    host_landed: float = 0.0   # when the bytes reach host DRAM (two-leg
    #                            device loads: the SSD leg's completion;
    #                            0.0 when not applicable / already there)

    @property
    def wait(self) -> float:
        """Queueing delay before the first leg starts."""
        return self.start - self.issued

    @property
    def latency(self) -> float:
        """Issue-to-completion time (all waits + all service legs)."""
        return self.done - self.issued


class TransferChannel:
    """One shared link of the tier topology (SSD or PCIe class)."""

    def __init__(self, name: str, bandwidth: float):
        if bandwidth <= 0:
            raise ValueError(f"channel {name!r} needs positive bandwidth")
        self.name = name
        self.bandwidth = bandwidth
        self.busy_until = 0.0
        # --- stats (reported in Metrics.memory) ------------------------- #
        self.transfers = 0
        self.bytes_moved = 0
        self.busy_time = 0.0
        self.wait_time = 0.0

    def duration(self, nbytes: int, overhead: float = 0.0) -> float:
        """Uncontended service time for one transfer."""
        return overhead + nbytes / self.bandwidth

    def begin(self, now: float, nbytes: int,
              overhead: float = 0.0) -> Transfer:
        """Schedule a transfer; it queues behind anything already in flight."""
        start = max(now, self.busy_until)
        dur = self.duration(nbytes, overhead)
        done = start + dur
        self.busy_until = done
        self.transfers += 1
        self.bytes_moved += nbytes
        self.busy_time += dur
        self.wait_time += start - now
        return Transfer(issued=now, start=start, done=done)

    def idle_at(self, now: float) -> bool:
        return self.busy_until <= now

    def snapshot(self) -> dict:
        return {"transfers": self.transfers,
                "bytes_moved": self.bytes_moved,
                "busy_time_s": round(self.busy_time, 6),
                "wait_time_s": round(self.wait_time, 6)}
