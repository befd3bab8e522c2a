"""Pinned naive reference for the PR-7 scheduler/cost fast paths.

The fast paths (top-2 makespan argmin, queued-group index, epoch-validated
pending-time and peer-holder caches) must be decision-for-decision identical
to the straightforward implementations they replaced. This module *retains*
those implementations verbatim so the equivalence is testable forever, not
just against a git hash:

  ``ReferenceScheduler``      ``_assign_makespan`` as the O(n^2)
                              max-with-exclusion loop, ``additional_latency``
                              with the full queue rescan, ``reorder_head``
                              with the per-slot pool probe.
  ``reference_pending_time``  the uncached queue-work loop (same summation
                              order as ``Executor.queue_work``, so cached
                              and naive values are bit-identical).
  ``apply_reference``         swap a built ``CoServeSystem`` onto the naive
                              paths and disable every cache — the property
                              tests' control arm and ``bench_simperf``'s
                              pre-optimization baseline column.

Keep this module dependency-light and boring: it is the measuring stick,
not a serving mode.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Set

from repro_torch.core.scheduler import RequestScheduler

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.executor import Executor
    from repro_torch.core.serving import CoServeSystem


def reference_pending_time(ex: "Executor", now: float) -> float:
    """Naive ``pending_time``: busy remainder plus the queue-work loop
    recomputed from scratch (one load per distinct non-resident expert plus
    per-group exec latency), every call."""
    total = 0.0
    seen: Set[str] = set(ex.pool.resident)
    for g in ex.queue:
        prof = ex.profile(ex.coe.spec(g.expert_id).arch)
        if g.expert_id not in seen:
            total += ex.load_latency(g.expert_id)
            seen.add(g.expert_id)
        total += prof.exec_latency(len(g))
    return max(0.0, ex.busy_until - now) + total


class ReferenceScheduler(RequestScheduler):
    """``RequestScheduler`` with the pre-fast-path hot loops."""

    def additional_latency(self, ex: "Executor", req, now: float = 0.0
                           ) -> float:
        spec = ex.coe.spec(req.expert_id)
        prof = ex.profile(spec.arch)
        queued_same = any(g.expert_id == req.expert_id for g in ex.queue)
        if queued_same and self.policy.arrange:
            exec_lat = prof.k                      # joins an existing batch
        else:
            exec_lat = prof.k + prof.b
        return exec_lat + self.switch_cost(ex, req.expert_id, now,
                                           queued_same=queued_same)

    def _assign_makespan(self, req, now: float) -> "Executor":
        pending = [ex.pending_time(now) for ex in self.executors]
        adds = [self.additional_latency(ex, req, now)
                for ex in self.executors]
        best, best_key = None, None
        for i, ex in enumerate(self.executors):
            new_total = pending[i] + adds[i]
            makespan = max([new_total]
                           + [pending[j] for j in range(len(pending))
                              if j != i])
            key = (makespan, adds[i], i)
            if best_key is None or key < best_key:
                best, best_key = ex, key
        return best

    def reorder_head(self, ex: "Executor", now: float = 0.0):
        w = self.policy.lookahead
        if not w or len(ex.queue) < 2:
            return
        head = ex.queue[0]
        if head.expert_id in ex.pool:
            return
        for i in range(1, min(w + 1, len(ex.queue))):
            if ex.queue[i].expert_id in ex.pool:
                ex.queue.insert(0, ex.queue.pop(i))
                return


def apply_reference(system: "CoServeSystem") -> "CoServeSystem":
    """Route ``system`` through the naive reference paths in place: swap the
    scheduler for a ``ReferenceScheduler`` (carrying over tracer, priority
    hook and round-robin cursor) and disable the hierarchy's peer-holder
    cache and every executor's pending-time cache, so all hot-path work is
    recomputed per probe exactly as before PR 7."""
    old = system.scheduler
    ref = ReferenceScheduler(list(old.executors), old.policy)
    ref.tracer = old.tracer
    ref.priority_fn = old.priority_fn
    ref._rr = old._rr
    system.scheduler = ref
    system.hierarchy.cost_cache_enabled = False
    for ex in system.executors:
        ex.use_pending_cache = False
    return system
