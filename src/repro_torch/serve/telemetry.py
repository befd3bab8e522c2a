"""Streaming SLO telemetry: windowed throughput + online quantiles.

Source of truth: the only accumulator of streaming per-tenant / per-expert
statistics and SLO-violation counts — the autoscaler and reports consume
this hub's numbers; nothing else counts violations.

Offline ``Metrics`` sorts every latency after the run; a 24/7 stream cannot.
``P2Quantile`` is the P-square algorithm (Jain & Chlamtac 1985): O(1) memory
per tracked quantile, five markers adjusted per observation with parabolic
interpolation. ``P2QuantileBank`` runs every tracked quantile's markers in
lockstep through one flattened, unrolled update per observation — the hot
path behind ``LatencyTracker`` (p50/p95/p99 + mean/max), numerically
identical to one ``P2Quantile`` per q (pinned by tests, measured by the
simperf suite). ``TelemetryHub`` keeps one tracker per tenant and per
expert arch plus a sliding completion window for instantaneous throughput —
the signals the autoscaler and admission controller consume.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.coe import Request


class P2Quantile:
    """Single-quantile P-square estimator (O(1) memory)."""

    def __init__(self, q: float):
        self.q = q
        self._init: List[float] = []     # exact until 5 observations
        self.n = 0
        self._pos: List[float] = []      # marker positions n_i
        self._des: List[float] = []      # desired positions n'_i
        self._h: List[float] = []        # marker heights q_i

    def add(self, x: float):
        self.n += 1
        if self._h == []:
            self._init.append(x)
            if len(self._init) == 5:
                self._init.sort()
                self._h = list(self._init)
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                q = self.q
                self._des = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q,
                             3.0 + 2.0 * q, 5.0]
            return
        h, pos = self._h, self._pos
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            pos[i] += 1.0
        q = self.q
        incr = (0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0)
        for i in range(5):
            self._des[i] += incr[i]
        # adjust interior markers toward their desired positions
        for i in (1, 2, 3):
            d = self._des[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or \
                    (d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                d = 1.0 if d >= 1.0 else -1.0
                hp = self._parabolic(i, d)
                if not (h[i - 1] < hp < h[i + 1]):
                    hp = self._linear(i, d)
                h[i] = hp
                pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, n = self._h, self._pos
        return h[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1]) / (n[i] - n[i - 1]))

    def _linear(self, i: int, d: float) -> float:
        h, n = self._h, self._pos
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (n[j] - n[i])

    def value(self) -> float:
        if self._h:
            return self._h[2]
        if not self._init:
            return 0.0
        from repro_torch.core.serving import nearest_rank
        return nearest_rank(sorted(self._init), self.q)


class P2QuantileBank:
    """Every tracked quantile's P-square markers updated in lockstep.

    Numerically identical to one ``P2Quantile`` per q fed the same stream
    (pinned by tests/test_telemetry_quantiles.py) but one flattened row per
    quantile instead of a Python object: marker state lives in a 16-slot
    list unpacked to locals, the 5-wide marker loops are unrolled, and the
    constants the scalar code recomputes per observation are folded
    (``pos[0]``/``des[0]`` never move; markers 0 and 4 are never
    parabolically adjusted; the desired-position increments are fixed per
    q). ~2.5x the observations/sec of the per-q estimators — this is
    ``LatencyTracker``'s hot path, hit once per completion and once per
    executed stage.
    """

    # row layout: h0..h4, p1..p4, des1..des4, incr1..incr3
    def __init__(self, qs):
        self.qs = tuple(qs)
        self.n = 0
        self._init: List[float] = []     # exact until 5 observations
        self._rows: List[List[float]] = []

    def add(self, x: float):
        self.n += 1
        rows = self._rows
        if not rows:
            ini = self._init
            ini.append(x)
            if len(ini) == 5:
                ini.sort()
                h0, h1, h2, h3, h4 = ini
                for q in self.qs:
                    rows.append([h0, h1, h2, h3, h4,
                                 2.0, 3.0, 4.0, 5.0,
                                 1.0 + 2.0 * q, 1.0 + 4.0 * q,
                                 3.0 + 2.0 * q, 5.0,
                                 q / 2.0, q, (1.0 + q) / 2.0])
            return
        for row in rows:
            (h0, h1, h2, h3, h4, p1, p2, p3, p4,
             d1, d2, d3, d4, i1, i2, i3) = row
            # cell search + position bumps (pos[i] += 1 for i > k), fused
            if x < h0:
                h0 = x
                p1 += 1.0; p2 += 1.0; p3 += 1.0
            elif x >= h4:
                h4 = x
            elif x < h1:
                p1 += 1.0; p2 += 1.0; p3 += 1.0
            elif x < h2:
                p2 += 1.0; p3 += 1.0
            elif x < h3:
                p3 += 1.0
            p4 += 1.0
            d1 += i1; d2 += i2; d3 += i3; d4 += 1.0
            # interior markers toward desired positions (pos0 == 1.0)
            d = d1 - p1
            if (d >= 1.0 and p2 - p1 > 1.0) or \
                    (d <= -1.0 and 1.0 - p1 < -1.0):
                d = 1.0 if d >= 1.0 else -1.0
                hp = h1 + d / (p2 - 1.0) * (
                    (p1 - 1.0 + d) * (h2 - h1) / (p2 - p1)
                    + (p2 - p1 - d) * (h1 - h0) / (p1 - 1.0))
                if not (h0 < hp < h2):
                    if d == 1.0:
                        hp = h1 + (h2 - h1) / (p2 - p1)
                    else:
                        hp = h1 - (h0 - h1) / (1.0 - p1)
                h1 = hp
                p1 += d
            d = d2 - p2
            if (d >= 1.0 and p3 - p2 > 1.0) or \
                    (d <= -1.0 and p1 - p2 < -1.0):
                d = 1.0 if d >= 1.0 else -1.0
                hp = h2 + d / (p3 - p1) * (
                    (p2 - p1 + d) * (h3 - h2) / (p3 - p2)
                    + (p3 - p2 - d) * (h2 - h1) / (p2 - p1))
                if not (h1 < hp < h3):
                    if d == 1.0:
                        hp = h2 + (h3 - h2) / (p3 - p2)
                    else:
                        hp = h2 - (h1 - h2) / (p1 - p2)
                h2 = hp
                p2 += d
            d = d3 - p3
            if (d >= 1.0 and p4 - p3 > 1.0) or \
                    (d <= -1.0 and p2 - p3 < -1.0):
                d = 1.0 if d >= 1.0 else -1.0
                hp = h3 + d / (p4 - p2) * (
                    (p3 - p2 + d) * (h4 - h3) / (p4 - p3)
                    + (p4 - p3 - d) * (h3 - h2) / (p3 - p2))
                if not (h2 < hp < h4):
                    if d == 1.0:
                        hp = h3 + (h4 - h3) / (p4 - p3)
                    else:
                        hp = h3 - (h2 - h3) / (p2 - p3)
                h3 = hp
                p3 += d
            row[0] = h0; row[1] = h1; row[2] = h2; row[3] = h3
            row[4] = h4; row[5] = p1; row[6] = p2; row[7] = p3
            row[8] = p4; row[9] = d1; row[10] = d2; row[11] = d3
            row[12] = d4

    def values(self) -> List[float]:
        """Current estimates, one per q (exact below 5 observations)."""
        if self._rows:
            return [r[2] for r in self._rows]
        if not self._init:
            return [0.0] * len(self.qs)
        from repro_torch.core.serving import nearest_rank
        s = sorted(self._init)
        return [nearest_rank(s, q) for q in self.qs]


class LatencyTracker:
    """Mean/max + streaming p50/p95/p99 for one key (tenant, arch, ...)."""

    QS = (0.50, 0.95, 0.99)

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self._est = P2QuantileBank(self.QS)

    def add(self, latency: float):
        self.count += 1
        self.total += latency
        self.max = max(self.max, latency)
        self._est.add(latency)

    # a tail quantile estimated from fewer than this many tail samples
    # (count * (1-q)) is marked low-confidence in snapshots
    MIN_TAIL_SAMPLES = 10

    def snapshot(self) -> Dict[str, float]:
        # enforce quantile monotonicity (independent P2 estimators can cross
        # by estimation error on small samples): running max over p50<=p95<=p99
        vals = []
        hi = 0.0
        for v in self._est.values():
            hi = max(hi, v)
            vals.append(hi)
        return {"count": self.count,
                "mean": self.total / self.count if self.count else 0.0,
                "max": self.max,
                "p50": vals[0], "p95": vals[1], "p99": vals[2],
                "low_confidence": [
                    f"p{int(q * 100)}" for q in self.QS
                    if self.count * (1.0 - q) < self.MIN_TAIL_SAMPLES]}


class WindowRate:
    """Events-per-second over a sliding window of sim time."""

    def __init__(self, window_s: float = 10.0):
        self.window_s = window_s
        self._events: Deque[float] = collections.deque()

    def add(self, t: float):
        self._events.append(t)
        self._prune(t)

    def rate(self, now: float) -> float:
        self._prune(now)
        if not self._events:
            return 0.0
        # normalize by elapsed stream time until the window fills — dividing
        # by the distance to the oldest event explodes when one completion
        # lands at the sample instant
        span = min(self.window_s, max(now, 1e-9))
        return len(self._events) / span

    def _prune(self, now: float):
        while self._events and self._events[0] < now - self.window_s:
            self._events.popleft()


@dataclasses.dataclass
class TimelinePoint:
    """One periodic telemetry sample (the ticker writes these)."""
    t: float
    queue_depth: int
    executors: int
    throughput: float
    violation_rate: float
    shed: int


class TelemetryHub:
    """Aggregates streaming serving telemetry.

    Schema of ``snapshot()`` (also the CLI/benchmark JSON):
      arrived / completed / shed      — request counts
      throughput_rps                  — completions/s over the sliding window
      latency                         — overall LatencyTracker snapshot
      per_tenant[t]                   — end-to-end tracker + slo {target,
                                        violations, violation_rate}
      per_expert[arch]                — per-STAGE latency tracker (each chain
                                        hop samples the arch that served it)
      queue                           — max/final depth from the ticker
    (the full per-tick ``timeline`` is surfaced via OnlineReport)
    """

    def __init__(self, slo_targets: Optional[Dict[str, float]] = None,
                 window_s: float = 10.0):
        self.slo_targets = dict(slo_targets or {})
        self.arrived = 0
        self.completed = 0
        self.shed = 0
        self.shed_by_tenant: Dict[str, int] = {}
        self.overall = LatencyTracker()
        self.per_tenant: Dict[str, LatencyTracker] = {}
        self.per_expert: Dict[str, LatencyTracker] = {}
        self.violations: Dict[str, int] = {}
        self.tenant_completed: Dict[str, int] = {}
        self.window = WindowRate(window_s)
        self.timeline: List[TimelinePoint] = []
        self.max_queue_depth = 0
        # token-level decode (PR 9): streaming TTFT and inter-token latency,
        # fed by DecodeRuntime.attach_telemetry; empty when decode is off
        # (and then omitted from snapshot() so the schema is unchanged)
        self.ttft = LatencyTracker()
        self.token = LatencyTracker()

    # --- event hooks ---------------------------------------------------- #
    def on_arrival(self, req: Request, now: float):
        self.arrived += 1

    def on_shed(self, req: Request, now: float):
        self.shed += 1
        self.shed_by_tenant[req.tenant] = \
            self.shed_by_tenant.get(req.tenant, 0) + 1

    def on_complete(self, req: Request, now: float):
        """Chain-terminal completion: end-to-end latency, per tenant."""
        lat = now - req.e2e_arrival()
        self.completed += 1
        self.window.add(now)
        self.overall.add(lat)
        self.per_tenant.setdefault(req.tenant, LatencyTracker()).add(lat)
        self.tenant_completed[req.tenant] = \
            self.tenant_completed.get(req.tenant, 0) + 1
        target = self.slo_targets.get(req.tenant)
        if target is not None and lat > target:
            self.violations[req.tenant] = self.violations.get(req.tenant, 0) + 1

    def on_stage(self, req: Request, arch: str, now: float):
        """Every executed stage (incl. intermediate chain hops): the stage's
        own queue+exec latency, keyed by the arch that served it — chain
        latency must not be attributed to the terminal expert alone."""
        self.per_expert.setdefault(arch, LatencyTracker()).add(
            now - req.arrival_time)

    def on_first_token(self, latency: float):
        """Time-to-first-token of one request (arrival -> first decode
        step completion)."""
        self.ttft.add(latency)

    def on_token(self, latency: float):
        """One inter-token gap (consecutive decode-step completions)."""
        self.token.add(latency)

    def sample(self, now: float, queue_depth: int, executors: int):
        self.max_queue_depth = max(self.max_queue_depth, queue_depth)
        self.timeline.append(TimelinePoint(
            t=now, queue_depth=queue_depth, executors=executors,
            throughput=self.window.rate(now),
            violation_rate=self.violation_rate(), shed=self.shed))

    # --- derived signals ------------------------------------------------ #
    def violation_rate(self, tenant: Optional[str] = None) -> float:
        if tenant is not None:
            done = self.tenant_completed.get(tenant, 0)
            return self.violations.get(tenant, 0) / done if done else 0.0
        done = sum(self.tenant_completed.values())
        return sum(self.violations.values()) / done if done else 0.0

    def snapshot(self, now: float) -> dict:
        per_tenant = {}
        for t, tracker in sorted(self.per_tenant.items()):
            snap = tracker.snapshot()
            target = self.slo_targets.get(t)
            snap["slo"] = {
                "target_s": target,
                "violations": self.violations.get(t, 0),
                "violation_rate": round(self.violation_rate(t), 4),
                "shed": self.shed_by_tenant.get(t, 0),
            }
            per_tenant[t] = snap
        out = {
            "arrived": self.arrived,
            "completed": self.completed,
            "shed": self.shed,
            "throughput_rps": round(self.window.rate(now), 3),
            "latency": self.overall.snapshot(),
            "per_tenant": per_tenant,
            "per_expert": {a: tr.snapshot()
                           for a, tr in sorted(self.per_expert.items())},
            "queue": {"max_depth": self.max_queue_depth,
                      "final_depth": self.timeline[-1].queue_depth
                      if self.timeline else 0},
        }
        if self.ttft.count or self.token.count:
            out["decode"] = {"ttft": self.ttft.snapshot(),
                             "token": self.token.snapshot()}
        return out
