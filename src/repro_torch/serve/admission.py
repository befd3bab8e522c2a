"""Load-shedding admission control for the online gateway.

Source of truth: the only place an arrival may be rejected — shedding
happens on fresh SOURCE arrivals in one hook, never mid-chain and never
inside the scheduler, so "admitted" has exactly one meaning in telemetry.

Under sustained overload an open queue grows without bound and *every*
tenant's tail latency diverges. The controller gates fresh arrivals (never
in-flight follow-ups — shedding mid-chain would strand pinned experts and
waste the classification work already done) using one of three policies:

  queue_depth    — reject when total queued requests exceed ``max_queue``
                   (bounds memory and worst-case wait; the acceptance
                   criterion's bounded-vs-unbounded demonstration)
  deadline       — reject when the *predicted* wait on the best executor
                   already exceeds the request's SLO slack: work that is
                   guaranteed late is not worth admitting
  token_bucket   — per-tenant rate cap (burst-tolerant fairness: one tenant's
                   burst cannot crowd out the others' admission budget)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.coe import Request


@dataclasses.dataclass
class AdmissionConfig:
    policy: str = "queue_depth"      # queue_depth | deadline | token_bucket
    max_queue: int = 200             # queue_depth: global queued-request cap
    slack_factor: float = 1.0        # deadline: admit while wait < slack*SLO
    bucket_rate: float = 100.0       # token_bucket: tokens/s per tenant
    bucket_burst: float = 50.0       # token_bucket: capacity


class AdmissionController:
    """Callable gate: ``controller(sim, req) -> bool`` (False = shed).

    Wire it to ``Simulation.admission``; it only ever sees SOURCE arrivals,
    so chained follow-ups are structurally exempt.
    """

    def __init__(self, config: Optional[AdmissionConfig] = None):
        self.config = config or AdmissionConfig()
        self.admitted = 0
        self.rejected = 0
        self._tokens: Dict[str, float] = {}
        self._token_t: Dict[str, float] = {}

    # ------------------------------------------------------------------ #
    def __call__(self, sim, req: Request) -> bool:
        ok = self._decide(sim, req)
        if ok:
            self.admitted += 1
        else:
            self.rejected += 1
        return ok

    def _decide(self, sim, req: Request) -> bool:
        cfg = self.config
        if cfg.policy == "queue_depth":
            return sim.system.queue_depth() < cfg.max_queue
        if cfg.policy == "deadline":
            if req.deadline is None:
                return True
            waits = [e.pending_time(sim.now)
                     for e in sim.system.live_executors()]
            best_wait = min(waits) if waits else 0.0
            slack = req.deadline - sim.now
            return best_wait <= cfg.slack_factor * slack
        if cfg.policy == "token_bucket":
            t_last = self._token_t.get(req.tenant, sim.now)
            level = self._tokens.get(req.tenant, cfg.bucket_burst)
            level = min(cfg.bucket_burst,
                        level + (sim.now - t_last) * cfg.bucket_rate)
            self._token_t[req.tenant] = sim.now
            if level >= 1.0:
                self._tokens[req.tenant] = level - 1.0
                return True
            self._tokens[req.tenant] = level
            return False
        raise ValueError(f"unknown admission policy {cfg.policy!r}")

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        total = self.admitted + self.rejected
        return {"policy": self.config.policy, "admitted": self.admitted,
                "rejected": self.rejected,
                "rejection_rate": self.rejected / total if total else 0.0}
