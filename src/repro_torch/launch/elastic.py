"""Elastic executor scaling + graceful drain (large-scale runnability).

``ElasticController`` watches queue pressure on a periodic tick and grows or
shrinks the executor fleet between ``min_executors``/``max_executors``.
Scale-down is a *graceful drain*: the victim executor's queued groups are
re-scheduled through the dependency-aware scheduler (at-most-once, by request
id), exactly the path a node failure takes — so elasticity and fault
tolerance share one code path and one set of tests.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.serving import CoServeSystem, ExecutorSpec
from repro_torch.core.simulator import ARRIVAL, INJECT, Simulation


@dataclasses.dataclass
class ElasticPolicy:
    min_executors: int = 1
    max_executors: int = 8
    scale_up_pending_s: float = 2.0    # avg queue time that triggers growth
    scale_down_pending_s: float = 0.2  # avg queue time that triggers shrink
    tick_s: float = 0.5
    cooldown_ticks: int = 2            # ticks between scaling actions


class ElasticController:
    """Periodic autoscaler driven through the simulator's INJECT events."""

    def __init__(self, system: CoServeSystem, spec: ExecutorSpec,
                 policy: ElasticPolicy = ElasticPolicy()):
        self.system = system
        self.spec = spec
        self.policy = policy
        self.actions: List[dict] = []
        self._cooldown = 0

    # ------------------------------------------------------------------ #
    def install(self, sim: Simulation, horizon_s: float):
        t = self.policy.tick_s
        while t <= horizon_s:
            sim.inject(t, self._tick)
            t += self.policy.tick_s

    # ------------------------------------------------------------------ #
    def _tick(self, sim: Simulation):
        live = self.system.live_executors()
        if not live:
            return
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        pending = [ex.pending_time(sim.now) for ex in live]
        avg = sum(pending) / len(pending)
        if avg > self.policy.scale_up_pending_s \
                and len(live) < self.policy.max_executors:
            ex = self.system.add_executor(self.spec)
            self.actions.append(
                {"t": sim.now, "action": "add", "executor": ex.id,
                 "avg_pending": avg})
            self._cooldown = self.policy.cooldown_ticks
        elif avg < self.policy.scale_down_pending_s \
                and len(live) > self.policy.min_executors:
            victim = min(live, key=lambda e: e.pending_time(sim.now))
            self.drain(sim, victim)
            self.actions.append(
                {"t": sim.now, "action": "remove", "executor": victim.id,
                 "avg_pending": avg})
            self._cooldown = self.policy.cooldown_ticks

    # ------------------------------------------------------------------ #
    def drain(self, sim: Simulation, ex) -> None:
        """Graceful scale-down: re-schedule the victim's queued work."""
        orphans = self.system.fail_executor(ex, sim.now)
        for r in orphans:
            sim.push(sim.now, ARRIVAL, r)
        for peer in self.system.live_executors():
            sim.kick(peer, sim.now)
