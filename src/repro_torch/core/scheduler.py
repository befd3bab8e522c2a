"""Dependency-aware request scheduling (paper §4.2).

Four stages, exactly as the paper defines them:
  1. *Prediction* — additional latency of placing a request on each queue:
     execution is the linear model K·n+B (K if it joins an existing group);
     switching is zero if the expert is resident (a) or already queued (b),
     else the *residency-aware* assignment cost: the uncontended service
     time from the tier the expert actually occupies (DEVICE on this pool /
     HOST / DISK) plus the backlog of the specific link(s) the load would
     ride — the same contended channels the TransferEngine charges and the
     prefetcher gates on, replacing the seed's executor-local
     ``load_latency`` guess.
  2. *Assigning* — minimise the makespan over executor queues; ties broken by
     the smallest added latency for the new request (Fig. 8).
  3. *Arranging* — place the request directly behind queued requests that use
     the same expert, so an expert loads at most once per group (Fig. 9).
  4. *Splitting* — batches capped by min(profiled max batch, memory-bound
     batch) at execution time (Fig. 9, right).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, TYPE_CHECKING

from repro_torch.core.coe import Request
from repro_torch.obs import NULL_TRACER

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.executor import Executor


@dataclasses.dataclass
class Group:
    """Consecutive same-expert requests in a queue (batched together)."""
    expert_id: str
    requests: List[Request]
    deadline: Optional[float] = None   # earliest member deadline (SLO mode)

    def __len__(self):
        return len(self.requests)


def bump_queue(queue) -> None:
    """Record an in-place Group mutation (requests joined or split) on an
    executor queue. ``TrackedQueue`` versions every *list* mutation itself,
    but a Group growing or shrinking in place changes the queue's predicted
    work without touching the list — the two sites that do that call this.
    No-op for plain lists (tests sometimes swap one in)."""
    bump = getattr(queue, "bump", None)
    if bump is not None:
        bump()


@dataclasses.dataclass(frozen=True)
class SchedulerPolicy:
    assign: str = "makespan"     # makespan | round_robin | single
    arrange: bool = True         # group same-expert requests (paper §4.2)
    lookahead: int = 0           # beyond-paper: dequeue-time window re-sort


class RequestScheduler:
    """Assigns arriving requests to executor queues and arranges them."""

    def __init__(self, executors: Sequence["Executor"],
                 policy: SchedulerPolicy = SchedulerPolicy()):
        self.executors = list(executors)
        self.policy = policy
        self._rr = 0
        self.tracer = NULL_TRACER    # set by CoServeSystem when tracing
        # optional SLO hook (repro_torch.serve): maps a request to its absolute
        # deadline. When set, new groups are placed earliest-deadline-first
        # within the queue instead of appended; None preserves paper order.
        self.priority_fn: Optional[Callable[[Request], float]] = None

    # ------------------------------------------------------------------ #
    # prediction (paper §4.2 "Prediction of additional inference latency")
    # ------------------------------------------------------------------ #
    def additional_latency(self, ex: "Executor", req: Request,
                           now: float = 0.0) -> float:
        spec = ex.coe.spec(req.expert_id)
        prof = ex.profile(spec.arch)
        # O(1) queued-same probe against the executor's lazily-rebuilt
        # queued-group index (the naive reference rescans the whole queue)
        queued_same = req.expert_id in ex.queued_groups()
        if queued_same and self.policy.arrange:
            exec_lat = prof.k                      # joins an existing batch
        else:
            exec_lat = prof.k + prof.b
        return exec_lat + self.switch_cost(ex, req.expert_id, now,
                                           queued_same=queued_same)

    def switch_cost(self, ex: "Executor", expert_id: str, now: float,
                    queued_same: bool = False) -> float:
        """Residency-aware switch cost of running ``expert_id`` on ``ex``.

        Zero for condition (b) (already queued: the load is paid once per
        group) and for a settled resident of this executor's pool
        (condition (a)). A copy still LOADING into the pool costs its
        remaining in-flight time, not zero and not a full reload. Otherwise
        the memory hierarchy prices the load from where the expert really is
        (a sibling pool over the peer fabric / HOST / DISK) plus the queue
        of the specific link(s) this executor's device would ride — so an
        executor behind a congested PCIe channel or peer ingress port
        genuinely looks more expensive than a replica-holding one, and all
        consumers (scheduler, TransferEngine, prefetcher) agree on the same
        contended-channel state.

        Heterogeneous CPU co-execution (``policy.host_exec``) also lives in
        that hierarchy cost: a host-DRAM-resident expert is ~free to switch
        onto a host/CPU executor (it runs in place), so the makespan argmin
        over the executor set prices min(execute_on_host,
        load_then_execute_on_device) per arrival with no extra branch here —
        the CPU arm simply wins when its switch cost plus its (slower)
        exec latency beats every device arm's load-plus-exec.
        """
        if queued_same:
            return 0.0
        pool = ex.pool
        if expert_id in pool:
            done = pool.loading.get(expert_id)
            if done is None or expert_id in pool.ready:
                return 0.0
            return max(0.0, done - now)
        h = ex.hierarchy
        if h is not None:
            return h.assignment_cost(expert_id, now, group=ex.link_group,
                                     device=ex.device)
        return ex.load_latency(expert_id)

    # ------------------------------------------------------------------ #
    # assigning (paper §4.2 "Request assigning")
    # ------------------------------------------------------------------ #
    def assign(self, req: Request, now: float) -> "Executor":
        if self.policy.assign == "single" or len(self.executors) == 1:
            ex = self.executors[0]
        elif self.policy.assign == "round_robin":
            ex = self.executors[self._rr % len(self.executors)]
            self._rr += 1
        else:
            ex = self._assign_makespan(req, now)
        self._arrange(ex, req)
        if self.tracer.full:
            self.tracer.emit(now, "sched", "scheduler", req.expert_id,
                             request=req.id, executor=ex.id,
                             mode=self.policy.assign)
        return ex

    def _assign_makespan(self, req: Request, now: float) -> "Executor":
        """Argmin over executors of (makespan if assigned here, added
        latency, index). The naive reference recomputes the max over all
        *other* queues per candidate — O(n^2) per arrival; here the top-2
        pending times give that exclusion max in O(1): the largest pending
        time unless the candidate IS the argmax, else the second largest.
        Identical keys, identical argmin (pinned against the reference)."""
        pending = [ex.pending_time(now) for ex in self.executors]
        hi1 = hi2 = float("-inf")
        hi1_i = -1
        for i, p in enumerate(pending):
            if p > hi1:
                hi2 = hi1
                hi1, hi1_i = p, i
            elif p > hi2:
                hi2 = p
        # ``additional_latency``/``switch_cost`` inlined: the methods stay
        # (reference tests, steal heuristics, the manager) but paying two
        # dispatches plus a catalog lookup per executor per arrival is the
        # residual hot spot at 128 devices — same branches, same values
        eid = req.expert_id
        arch = self.executors[0].coe.spec(eid).arch
        arrange = self.policy.arrange
        best, best_key = None, None
        for i, ex in enumerate(self.executors):
            prof = ex.device_profile.arch_profiles[arch]
            queued_same = eid in ex.queued_groups()
            exec_lat = prof.k if (queued_same and arrange) \
                else prof.k + prof.b
            if queued_same:
                sc = 0.0
            else:
                pool = ex.pool
                if eid in pool:
                    done = pool.loading.get(eid)
                    sc = 0.0 if done is None or eid in pool.ready \
                        else max(0.0, done - now)
                elif ex.hierarchy is not None:
                    sc = ex.hierarchy.assignment_cost(
                        eid, now, group=pool.group, device=ex.device)
                else:
                    sc = ex.load_latency(eid)
            add = exec_lat + sc
            new_total = pending[i] + add
            others = hi2 if i == hi1_i else hi1
            makespan = new_total if new_total >= others else others
            key = (makespan, add, i)
            if best_key is None or key < best_key:
                best, best_key = ex, key
        return best

    # ------------------------------------------------------------------ #
    # arranging (paper §4.2 "Request arranging")
    # ------------------------------------------------------------------ #
    def _arrange(self, ex: "Executor", req: Request):
        deadline = self.priority_fn(req) if self.priority_fn else None
        if self.policy.arrange:
            for g in reversed(ex.queue):
                if g.expert_id == req.expert_id:
                    g.requests.append(req)
                    bump_queue(ex.queue)   # group grew in place
                    if deadline is not None:
                        g.deadline = deadline if g.deadline is None \
                            else min(g.deadline, deadline)
                    return
        elif ex.queue and ex.queue[-1].expert_id == req.expert_id:
            # FCFS baselines still batch *consecutive* same-expert arrivals
            ex.queue[-1].requests.append(req)
            bump_queue(ex.queue)           # group grew in place
            if deadline is not None:
                g = ex.queue[-1]
                g.deadline = deadline if g.deadline is None \
                    else min(g.deadline, deadline)
            return
        group = Group(expert_id=req.expert_id, requests=[req],
                      deadline=deadline)
        if deadline is not None:
            # earliest-deadline-first insertion; stable among equal deadlines
            # (deadline-less groups sort last), so urgent tenants overtake
            # slack ones without starving them
            for i, g in enumerate(ex.queue):
                if g.deadline is None or g.deadline > deadline:
                    ex.queue.insert(i, group)
                    return
        ex.queue.append(group)

    # ------------------------------------------------------------------ #
    # beyond-paper: bounded lookahead re-sort at dequeue time — pull a
    # same-expert group from within the window to the head when the head
    # expert is not resident but a later one is (saves a switch).
    # ------------------------------------------------------------------ #
    def reorder_head(self, ex: "Executor", now: float = 0.0):
        w = self.policy.lookahead
        if not w or len(ex.queue) < 2:
            return
        head = ex.queue[0]
        if head.expert_id in ex.pool:
            return
        # queued-expert index: intersect the queue's expert set with the
        # pool's residents once, instead of probing pool membership per
        # window slot — the common all-cold window exits here
        hits = ex.queued_groups().keys() & ex.pool.resident.keys()
        if not hits:
            return
        for i in range(1, min(w + 1, len(ex.queue))):
            if ex.queue[i].expert_id in hits:
                ex.queue.insert(0, ex.queue.pop(i))
                if self.tracer.full:
                    # reorders were invisible to the flight recorder before
                    self.tracer.emit(now, "sched", "scheduler",
                                     ex.queue[0].expert_id, executor=ex.id,
                                     mode="reorder", slot=i)
                return


def split_batch(group: Group, max_exec_batch: int) -> List[Request]:
    """Pop at most ``max_exec_batch`` requests from the group head
    (paper §4.2 "Request splitting")."""
    take = min(len(group.requests), max(1, max_exec_batch))
    batch = group.requests[:take]
    del group.requests[:take]
    return batch


def max_executable_batch(profile, batch_bytes_available: int) -> int:
    """min(profiled max batch, what activation memory accommodates)."""
    by_mem = batch_bytes_available // max(1, profile.act_bytes_per_item)
    return max(1, min(profile.max_batch, by_mem))
