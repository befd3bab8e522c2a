"""Load-driven executor autoscaling over the elasticity hooks.

Source of truth: the only runtime caller of ``add_executor`` /
``fail_executor`` / ``rebalance_placement`` on the online path — fleet
shape changes, their batch-budget re-division and the resulting placement
rebalances all originate from this control loop's ``step``.

The seed already supports runtime topology changes (``add_executor`` /
``fail_executor`` + INJECT, built for the fault-tolerance tests); this module
closes the loop: a periodic controller reads queue depth and SLO-violation
telemetry and scales the executor fleet between ``min_executors`` and
``max_executors``.

Relative to the offline ``launch.elastic.ElasticController`` (which pre-
materializes INJECT ticks over a fixed horizon), this controller rides the
simulator's self-rescheduling TICK events, so it works on unbounded streams,
and it adds the SLO-violation signal from streaming telemetry.

Scale-up when either signal is hot (queued requests per executor above
``up_queue_per_executor``, or windowed violation rate above
``up_violation_rate``); scale-down only when the queue is cold AND the SLO is
comfortably met. Asymmetric thresholds + a cooldown give hysteresis so the
controller doesn't flap on bursty traffic. Scale-down drains by failing the
emptiest *scaled* executor — its orphaned requests re-enter the arrival path
(at-most-once), exactly like the fault-tolerance path, so no work is lost.
Baseline executors (the operator-configured floor) are never removed.
Because scaled executors share the same physical device pool, the fleet's
total activation (batch) memory is held fixed and re-divided on every
scaling action — more executors mean more parallel queues and load channels,
not conjured memory.

On a multi-device fleet the controller is topology-aware: scale-up targets
the device pool with the highest queued-requests-per-executor (not a fixed
``pool_group``), and every scaling action rebalances the system's
``PlacementPlan`` — replication is re-planned with pools weighted by their
new executor counts and the hottest missing replicas are pulled in through
the contended load path — so placement follows capacity instead of staying
frozen at construction.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.serving import ExecutorSpec

from repro_torch.serve.telemetry import TelemetryHub


@dataclasses.dataclass
class AutoscalerConfig:
    spec: ExecutorSpec                   # template for scaled-up executors
    min_executors: int = 1
    max_executors: int = 8
    up_queue_per_executor: float = 12.0  # scale up above this queue pressure
    down_queue_per_executor: float = 2.0 # scale down below this
    up_violation_rate: float = 0.10      # scale up above this SLO violation rate
    down_violation_rate: float = 0.01    # scale down only below this
    cooldown_s: float = 5.0              # min gap between scaling actions
    fleet_aware: bool = True             # scale-up picks the hottest device
    #                                      pool; actions rebalance placement
    rebalance_loads: int = 4             # max replica loads per scale event


@dataclasses.dataclass
class ScaleEvent:
    t: float
    action: str          # "up" | "down"
    executor_id: str
    reason: str
    n_executors: int     # fleet size after the action


class Autoscaler:
    """Periodic control step; wire via ``sim.add_ticker(interval, as_.step)``."""

    def __init__(self, config: AutoscalerConfig,
                 telemetry: Optional[TelemetryHub] = None):
        self.config = config
        self.telemetry = telemetry
        self.events: List[ScaleEvent] = []
        self._scaled_ids: List[str] = []     # executors this loop added
        self._last_action_t = -1e30
        self._last_violations = 0
        self._last_completed = 0
        self._batch_budgets: dict = {}             # fixed activation regions
        self.placement_loads = 0                   # replica loads issued

    # ------------------------------------------------------------------ #
    def _pool_group(self) -> str:
        return self.config.spec.pool_group or self.config.spec.device

    def _target_group(self, sim) -> str:
        """Which device pool a scale-up lands on: the spec's own group, or —
        fleet-aware — the compatible pool with the highest queued requests
        per executor (ties to the spec's group), so capacity goes where the
        backlog is."""
        base = self._pool_group()
        if not self.config.fleet_aware:
            return base
        kind = self.config.spec.device
        membership = getattr(sim.system, "pool_devices", {})
        cands = [g for g, dev in membership.items() if dev == kind] or [base]
        per_group: dict = {g: [0, 0] for g in cands}     # [queued, execs]
        for e in sim.system.live_executors():
            if e.pool.group in per_group:
                per_group[e.pool.group][0] += e.queued_requests()
                per_group[e.pool.group][1] += 1
        return max(cands, key=lambda g: (
            per_group[g][0] / max(1, per_group[g][1]), g == base))

    def _rebalance_batch(self, sim, group: str):
        """The modeled device's activation region is fixed: adding executors
        must split it, not mint new memory. The budget is the memory
        hierarchy's construction-time activation accounting for this pool
        group (expert-pool bytes stay with the shared DevicePool); re-divide
        it across all live executors on the scaled pool."""
        peers = [e for e in sim.system.live_executors()
                 if e.pool.group == group]
        if not peers:
            return
        if group not in self._batch_budgets:
            hierarchy = getattr(sim.system, "hierarchy", None)
            budget = hierarchy.batch_budget(group) if hierarchy else 0
            self._batch_budgets[group] = \
                budget or sum(e.batch_bytes for e in peers)
        share = self._batch_budgets[group] // len(peers)
        for e in peers:
            e.batch_bytes = share

    def _rebalance_placement(self, sim, now: float):
        """Scale events rebalance the PlacementPlan, not just batch budgets:
        replication follows the fleet's new shape and the issued replica
        loads get their LOAD_DONE events like any other transfer."""
        if not self.config.fleet_aware:
            return
        rebalance = getattr(sim.system, "rebalance_placement", None)
        if rebalance is None:
            return
        from repro_torch.core.simulator import LOAD_DONE
        for ex, eid, done in rebalance(now,
                                       max_loads=self.config.rebalance_loads):
            self.placement_loads += 1
            sim.push(done, LOAD_DONE, (ex, eid))

    def _record(self, sim, ev: ScaleEvent):
        self.events.append(ev)
        tracer = sim.system.tracer
        if tracer.enabled:
            tracer.emit(ev.t, "scale", "autoscaler", ev.action,
                        executor=ev.executor_id, reason=ev.reason,
                        n_executors=ev.n_executors)

    # ------------------------------------------------------------------ #
    def _window_violation_rate(self) -> float:
        """Violation rate since the previous *actionable* control step (not
        lifetime — a long good history must not mask a fresh overload).
        Only called once past the cooldown gate, so violations accrued
        during cooldown still count toward the next decision."""
        if self.telemetry is None:
            return 0.0
        viol = sum(self.telemetry.violations.values())
        done = sum(self.telemetry.tenant_completed.values())
        d_viol = viol - self._last_violations
        d_done = done - self._last_completed
        self._last_violations, self._last_completed = viol, done
        return d_viol / d_done if d_done > 0 else 0.0

    def step(self, sim, now: float):
        cfg = self.config
        if now - self._last_action_t < cfg.cooldown_s:
            return
        live = sim.system.live_executors()
        n = len(live)
        pressure = sim.system.queue_depth() / n if n else float("inf")
        vrate = self._window_violation_rate()

        if n < cfg.max_executors and (
                pressure > cfg.up_queue_per_executor
                or vrate > cfg.up_violation_rate):
            group = self._target_group(sim)
            spec = cfg.spec if group == self._pool_group() \
                else dataclasses.replace(cfg.spec, pool_group=group)
            self._rebalance_batch(sim, group)   # snapshot budget pre-growth
            ex = sim.system.add_executor(spec)
            self._rebalance_batch(sim, group)
            self._scaled_ids.append(ex.id)
            self._last_action_t = now
            reason = (f"queue_pressure={pressure:.1f}"
                      if pressure > cfg.up_queue_per_executor
                      else f"violation_rate={vrate:.3f}")
            self._record(sim, ScaleEvent(now, "up", ex.id, reason, n + 1))
            self._rebalance_placement(sim, now)
            return

        if n > cfg.min_executors and self._scaled_ids \
                and pressure < cfg.down_queue_per_executor \
                and vrate <= cfg.down_violation_rate:
            victim = self._pick_victim(sim)
            if victim is None:
                return
            victim_group = victim.pool.group
            from repro_torch.core.simulator import ARRIVAL
            orphans = sim.system.fail_executor(victim, now)
            for r in orphans:
                sim.push(now, ARRIVAL, r)    # re-queue, like the failure path
            for peer in sim.system.live_executors():
                sim.kick(peer, now)
            self._rebalance_batch(sim, victim_group)
            self._scaled_ids.remove(victim.id)
            self._last_action_t = now
            self._record(sim, ScaleEvent(
                now, "down", victim.id,
                f"queue_pressure={pressure:.1f}", n - 1))
            self._rebalance_placement(sim, now)

    def _pick_victim(self, sim):
        """Emptiest scaled-up executor (cheapest drain); never the baseline
        fleet, never one mid-load."""
        cands = [e for e in sim.system.live_executors()
                 if e.id in self._scaled_ids and e.load_in_flight is None]
        if not cands:
            return None
        return min(cands, key=lambda e: (e.queued_requests(),
                                         e.current is not None))

    # ------------------------------------------------------------------ #
    def summary(self) -> dict:
        return {
            "actions": len(self.events),
            "scale_ups": sum(1 for e in self.events if e.action == "up"),
            "scale_downs": sum(1 for e in self.events if e.action == "down"),
            "placement_loads": self.placement_loads,
            "events": [dataclasses.asdict(e) for e in self.events],
        }
