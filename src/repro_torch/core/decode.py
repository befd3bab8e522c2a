"""Token-level continuous batching with paged KV-cache residency (PR 9).

Source of truth: the only owner of decode-phase state — which requests are
mid-generation on which executor, how many KV blocks each holds and on which
tier. The simulator turns a request's terminal stage into prefill (the
existing ``exec`` event) followed by per-step decode events driven from here;
``decode = off`` (``CoServeSystem.decode is None``) leaves every consumer on
its existing stage-level path bit-for-bit.

The memory model mirrors vLLM-style paged attention scaled to CoServe's
regime: KV grows in fixed blocks (``block_tokens * token_bytes``) that
occupy *device* bytes next to expert weights (``DevicePool.kv_bytes``), so
under the paper's 4.5x/8x memory pressure KV and weights genuinely fight
over the same capacity. Two eviction disciplines are benchmarked:

  ``kv_aware``     idle requests' KV blocks offload to host DRAM over the
                   (contended) PCIe link when the pool needs room — for a
                   growing batch or an incoming expert load — and reload
                   before their owner's next step; the reload debt is priced
                   into ``MemoryHierarchy.assignment_cost`` so the scheduler
                   steers new work away from KV-thrashed pools.
  ``weight_only``  KV is pinned on device (the seed's implicit behaviour);
                   only expert weights evict. Device capacity left for
                   weights shrinks as batches grow, so weight reloads ride
                   the slow disk path more often — the contrast
                   ``BENCH_decode.json`` quantifies.

Determinism: token counts are drawn from a per-request hash-seeded stream
(order-independent), step latency is the linear model ``step_b + step_k*n``
(or the real engine's measured kernel time), and every transfer rides the
hierarchy's contended channels — so two runs of one seeded spec produce
identical event streams, the same discipline the tracer pins.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import TYPE_CHECKING, Dict, List, Optional

from repro_torch.obs.tracer import NULL_TRACER

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.coe import Request
    from repro_torch.memory import MemoryHierarchy
    from repro_torch.memory.residency import DevicePool


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Token-level decode knobs (``api.spec.DecodeSection`` resolves here).

    ``token_bytes`` is per-token KV across the expert's layers (the
    ``models.kvcache.slot_cache_shape`` footprint); one block holds
    ``block_tokens`` tokens, so the default block is ~4 MiB. ``kv_budget``
    caps KV at a fraction of each pool — eMoE-style task-aware budgeting —
    beyond which fresh blocks spill to host at birth."""
    tokens: int = 24                  # mean generated tokens per request
    tokens_dist: str = "fixed"        # "fixed" | "geometric"
    block_tokens: int = 16            # tokens per paged KV block
    token_bytes: int = 262_144        # KV bytes per token across layers
    kv_budget_fraction: float = 0.5   # max pool fraction KV may occupy
    kv_evict: str = "kv_aware"        # "kv_aware" | "weight_only"
    max_decode_batch: int = 8         # continuous-batch membership cap
    step_k: float = 0.002             # per-member seconds per decode step
    step_b: float = 0.0005            # fixed per-step overhead seconds
    seed: int = 0                     # token-count draw stream


@dataclasses.dataclass
class DecodeState:
    """One mid-generation request: its continuous-batch slot + KV ledger."""
    req: "Request"
    ex_id: str
    group: str                        # device pool the KV lives against
    tokens_total: int
    admit_t: float
    prev_token_t: float
    tokens_done: int = 0
    blocks_device: int = 0
    blocks_host: int = 0              # offloaded or spilled-at-birth
    last_step: int = 0                # recency for idle-victim ordering
    reloads: int = 0


def _pct(sorted_xs: List[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted sample (matches
    ``core.serving.nearest_rank`` — duplicated to keep this module free of
    a serving import cycle)."""
    if not sorted_xs:
        return 0.0
    k = max(0, min(len(sorted_xs) - 1, math.ceil(q * len(sorted_xs)) - 1))
    return sorted_xs[k]


def _lat_stats(samples: List[float]) -> dict:
    xs = sorted(samples)
    n = len(xs)
    return {"count": n,
            "mean": (sum(xs) / n) if n else 0.0,
            "p50": _pct(xs, 0.50),
            "p99": _pct(xs, 0.99)}


class DecodeRuntime:
    """Continuous-batch + KV-residency state machine.

    Driven by the simulator loop: ``admit`` when a terminal stage's prefill
    finishes, ``start_step``/``finish_step`` around each DECODE event,
    ``fail_executor`` on fault injection. The executor's weight-load path
    calls ``expert_load_pressure`` so KV yields device bytes to incoming
    experts (kv_aware), and the hierarchy prices ``reload_debt`` into
    assignment costs.
    """

    def __init__(self, cfg: DecodeConfig, hierarchy: "MemoryHierarchy",
                 tracer=None, engine=None):
        self.cfg = cfg
        self.hierarchy = hierarchy
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # real backend hook: an engine exposing ``decode_step`` supplies
        # measured kernel time per step instead of the linear model
        self.engine = engine if hasattr(engine, "decode_step") else None
        self.block_bytes = cfg.block_tokens * cfg.token_bytes
        self.states: Dict[int, DecodeState] = {}      # rid -> state
        self.batch: Dict[str, List[int]] = {}         # ex.id -> member rids
        self._inflight: Dict[str, List[int]] = {}     # ex.id -> stepping rids
        self._host_kv: Dict[str, int] = {}            # group -> host KV bytes
        self._step_seq = 0
        self.hub = None                               # TelemetryHub (optional)
        # counters surfaced in Metrics.decode
        self.tokens_out = 0
        self.kv_offload_events = 0
        self.kv_offload_bytes = 0
        self.kv_reload_events = 0
        self.kv_reload_bytes = 0
        self.kv_spills = 0
        self.peak_kv: Dict[str, int] = {}
        self.ttft_samples: List[float] = []
        self.token_samples: List[float] = []

    # ------------------------------------------------------------------ #
    # membership
    # ------------------------------------------------------------------ #
    def _tokens_for(self, rid: int) -> int:
        """Deterministic, order-independent token-count draw: seeded per
        request so replaying a subset of requests draws identical lengths
        (reference-pinning discipline). String seeding is stable across
        processes — tuple seeding would ride the randomized hash()."""
        cfg = self.cfg
        if cfg.tokens_dist == "fixed":
            return max(1, cfg.tokens)
        u = random.Random(f"{cfg.seed}:{rid}:decode-tokens").random()
        p = 1.0 / max(1.0, float(cfg.tokens))
        # inverse-CDF geometric with mean ~= cfg.tokens
        return max(1, 1 + int(math.log1p(-u) / math.log1p(-p)))

    def has_room(self, ex) -> bool:
        return len(self.batch.get(ex.id, ())) < self.cfg.max_decode_batch

    def stepping(self, ex) -> bool:
        return ex.id in self._inflight

    def active(self) -> int:
        return len(self.states)

    def admit(self, ex, req: "Request", now: float) -> None:
        """Terminal-stage prefill finished: the request joins ``ex``'s
        continuous batch and gets its first KV block."""
        rid = req.id
        st = DecodeState(req=req, ex_id=ex.id, group=ex.pool.group,
                         tokens_total=self._tokens_for(rid),
                         admit_t=now, prev_token_t=now,
                         last_step=self._step_seq)
        self.states[rid] = st
        self.batch.setdefault(ex.id, []).append(rid)
        self._alloc_block(st, now, ex)

    # ------------------------------------------------------------------ #
    # the per-step loop
    # ------------------------------------------------------------------ #
    def start_step(self, ex, now: float) -> Optional[float]:
        """Begin one decode step over ``ex``'s current membership; returns
        its completion time (the simulator's DECODE event) or None when the
        batch is empty. Membership snapshots at step start: joiners wait for
        the next step boundary (continuous batching, not preemption)."""
        members = self.batch.get(ex.id)
        if not members:
            return None
        members = list(members)
        kv_wait = 0.0
        for rid in members:
            w = self._prepare_member(self.states[rid], now, ex)
            if w > kv_wait:
                kv_wait = w
        if self.engine is not None:
            step = self.engine.decode_step(
                ex, [self.states[r] for r in members], now)
        else:
            step = self.cfg.step_b + self.cfg.step_k * len(members)
        dur = kv_wait + step
        self._step_seq += 1
        for rid in members:
            self.states[rid].last_step = self._step_seq
        self._inflight[ex.id] = members
        ex.stats.busy_time += dur
        if self.tracer.full:
            self.tracer.emit(now, "decode", ex.id, "step", dur=dur,
                             requests=members, n=len(members),
                             kv_wait=kv_wait)
        return now + dur

    def finish_step(self, ex, now: float) -> List["Request"]:
        """One token landed for every member; returns requests that just
        generated their last token (the simulator completes them)."""
        members = self._inflight.pop(ex.id, [])
        queue = self.batch.get(ex.id, [])
        finished: List["Request"] = []
        for rid in members:
            st = self.states.get(rid)
            if st is None:
                continue
            st.tokens_done += 1
            self.tokens_out += 1
            if st.tokens_done == 1:
                ttft = now - st.req.e2e_arrival()
                self.ttft_samples.append(ttft)
                if self.hub is not None:
                    self.hub.on_first_token(ttft)
            else:
                lat = now - st.prev_token_t
                self.token_samples.append(lat)
                if self.hub is not None:
                    self.hub.on_token(lat)
            st.prev_token_t = now
            if st.tokens_done >= st.tokens_total:
                self._release(st, now)
                queue.remove(rid)
                del self.states[rid]
                finished.append(st.req)
            elif st.tokens_done % self.cfg.block_tokens == 0:
                self._alloc_block(st, now, ex)
        return finished

    def fail_executor(self, ex) -> List["Request"]:
        """Executor died mid-decode: drop its members' KV (device bytes
        return to the pool, host bytes stop owing reloads) and hand the
        orphaned requests back for re-assignment from scratch."""
        self._inflight.pop(ex.id, None)
        orphans: List["Request"] = []
        for rid in self.batch.pop(ex.id, []):
            st = self.states.pop(rid, None)
            if st is None:
                continue
            self._release(st, 0.0)
            st.req.done_time = 0.0
            orphans.append(st.req)
        return orphans

    # ------------------------------------------------------------------ #
    # KV block lifecycle
    # ------------------------------------------------------------------ #
    def _pool(self, group: str) -> Optional["DevicePool"]:
        return self.hierarchy.pools.get(group)

    def _kv_trace(self, now: float, st: DecodeState, op: str, nbytes: int):
        if self.tracer.enabled:
            self.tracer.emit(now, "kv", st.group, op, request=st.req.id,
                             bytes=nbytes, device_blocks=st.blocks_device,
                             host_blocks=st.blocks_host)

    def _grow_device(self, pool: "DevicePool", st: DecodeState,
                     nbytes: int, blocks: int):
        pool.kv_bytes += nbytes
        st.blocks_device += blocks
        pool.epoch.bump()
        if pool.kv_bytes > self.peak_kv.get(pool.group, 0):
            self.peak_kv[pool.group] = pool.kv_bytes

    def _alloc_block(self, st: DecodeState, now: float, ex) -> None:
        """Grow the request's KV by one block, preferring device residency:
        over-budget pools first offload idle peers (kv_aware), then the
        block spills to host at birth; within budget, expert weights evict
        LRU to make room (both disciplines — weights reload, KV doesn't)."""
        need = self.block_bytes
        pool = self._pool(st.group)
        if pool is None:
            st.blocks_host += 1
            return
        budget = int(pool.capacity * self.cfg.kv_budget_fraction)
        unified = self.hierarchy.spec.unified
        if pool.kv_bytes + need > budget and not unified \
                and self.cfg.kv_evict == "kv_aware":
            self._offload_idle(
                pool, now, keep=st.req.id,
                done=lambda: pool.kv_bytes + need <= budget)
        if pool.kv_bytes + need > budget:
            st.blocks_host += 1
            self.kv_spills += 1
            if not unified:
                self._host_kv[st.group] = \
                    self._host_kv.get(st.group, 0) + need
            self._kv_trace(now, st, "spill", need)
            return
        if need > pool.free_bytes():
            self._evict_weights(pool, need, now, ex)
        if need <= pool.free_bytes():
            self._grow_device(pool, st, need, 1)
            self._kv_trace(now, st, "grow", need)
        else:
            st.blocks_host += 1
            self.kv_spills += 1
            if not unified:
                self._host_kv[st.group] = \
                    self._host_kv.get(st.group, 0) + need
            self._kv_trace(now, st, "spill", need)

    def _prepare_member(self, st: DecodeState, now: float, ex) -> float:
        """Bring a member's host-resident KV back before its step. When the
        pool has room (within budget) the blocks rematerialize on device;
        otherwise they stream — the transfer is paid *every* step but the
        batch always makes progress (no admission deadlock). Returns the
        reload wait this member contributes to the step."""
        if st.blocks_host == 0:
            return 0.0
        if self.hierarchy.spec.unified:
            # UMA: one address space — spilled blocks are already reachable
            return 0.0
        pool = self._pool(st.group)
        nbytes = st.blocks_host * self.block_bytes
        materialize = False
        if pool is not None:
            budget = int(pool.capacity * self.cfg.kv_budget_fraction)
            if pool.kv_bytes + nbytes <= budget:
                if nbytes > pool.free_bytes():
                    self._evict_weights(pool, nbytes, now, ex)
                materialize = nbytes <= pool.free_bytes()
        tr = self.hierarchy.transfer.begin_kv_reload(
            now, nbytes, st.group, label=f"r{st.req.id}")
        self.kv_reload_events += 1
        self.kv_reload_bytes += nbytes
        st.reloads += 1
        if materialize:
            self._grow_device(pool, st, nbytes, st.blocks_host)
            self._host_kv[st.group] = \
                self._host_kv.get(st.group, 0) - nbytes
            st.blocks_host = 0
            self._kv_trace(now, st, "reload", nbytes)
        else:
            self._kv_trace(now, st, "stream", nbytes)
        return max(0.0, tr.done - now)

    def _offload_idle(self, pool: "DevicePool", now: float,
                      keep: int, done) -> None:
        """kv_aware pressure valve: offload whole requests' device KV to
        host DRAM over the PCIe link, least-recently-stepped first, until
        ``done()``. Members of an in-flight step and ``keep`` are skipped
        (their blocks are being read)."""
        busy = {r for mem in self._inflight.values() for r in mem}
        cands = sorted(
            (st for st in self.states.values()
             if st.group == pool.group and st.blocks_device > 0
             and st.req.id != keep and st.req.id not in busy),
            key=lambda s: (s.last_step, s.req.id))
        for st in cands:
            if done():
                return
            nbytes = st.blocks_device * self.block_bytes
            self.hierarchy.transfer.begin_kv_offload(
                now, nbytes, pool.group, label=f"r{st.req.id}")
            pool.kv_bytes -= nbytes
            st.blocks_host += st.blocks_device
            st.blocks_device = 0
            pool.epoch.bump()
            self._host_kv[pool.group] = \
                self._host_kv.get(pool.group, 0) + nbytes
            self.kv_offload_events += 1
            self.kv_offload_bytes += nbytes
            self._kv_trace(now, st, "offload", nbytes)

    def _evict_weights(self, pool: "DevicePool", need: int, now: float,
                       ex) -> None:
        """Evict LRU expert weights until ``need`` device bytes are free —
        used by BOTH disciplines when KV (within budget) wants room:
        weights can always reload from host/disk, KV state cannot be
        recomputed. Experts queued or executing anywhere on the pool are
        protected, same rule as ``Executor.start_load``."""
        protected = set()
        for peer in pool.users:
            protected.update(g.expert_id for g in peer.queue)
            if peer.current is not None:
                protected.add(peer.current[0])
            if peer.load_in_flight is not None:
                protected.add(peer.load_in_flight[0])
        order = sorted(pool.evictable(), key=lambda e: pool.resident[e])
        for victim in order:
            if pool.free_bytes() >= need:
                return
            if victim in protected:
                continue
            pool.remove(victim)
            ex.engine.unload(ex, victim)
            ex.stats.evictions += 1
            if self.tracer.enabled:
                self.tracer.emit(now, "evict", ex.id, victim,
                                 pool=pool.group, by="kv")

    def _release(self, st: DecodeState, now: float) -> None:
        nbytes = st.blocks_device * self.block_bytes
        pool = self._pool(st.group)
        if pool is not None and nbytes:
            pool.kv_bytes -= nbytes
            pool.epoch.bump()
        if st.blocks_host and not self.hierarchy.spec.unified:
            self._host_kv[st.group] = self._host_kv.get(st.group, 0) \
                - st.blocks_host * self.block_bytes
        self._kv_trace(now, st, "release",
                       nbytes + st.blocks_host * self.block_bytes)
        st.blocks_device = 0
        st.blocks_host = 0
        if self.engine is not None:
            release = getattr(self.engine, "decode_release", None)
            if release is not None:
                release(st.req.id)

    def expert_load_pressure(self, ex, expert_id: str, now: float) -> None:
        """An incoming expert load wants device bytes: under kv_aware, idle
        requests' KV yields the room first (PCIe offload) so the load
        displaces as few weights as possible. weight_only does nothing —
        KV stays pinned and weights fight over what's left."""
        if self.cfg.kv_evict != "kv_aware" or self.hierarchy.spec.unified:
            return
        pool = ex.pool
        need = self.hierarchy.coe.spec(expert_id).mem_bytes
        if need <= pool.free_bytes():
            return
        self._offload_idle(pool, now, keep=-1,
                           done=lambda: need <= pool.free_bytes())

    # ------------------------------------------------------------------ #
    # pricing + reporting
    # ------------------------------------------------------------------ #
    def reload_debt(self, group: str, now: float) -> float:
        """Predicted PCIe time to bring ``group``'s offloaded KV back — the
        latency a new assignment behind this pool's continuing batch would
        absorb. Priced with the same host-hit transfer formula expert loads
        use, so the scheduler compares like with like."""
        nbytes = self._host_kv.get(group, 0)
        if nbytes <= 0:
            return 0.0
        return self.hierarchy.transfer.predict(nbytes, in_host_cache=True)

    def attach_telemetry(self, hub) -> None:
        self.hub = hub

    def metrics_snapshot(self) -> dict:
        return {
            "tokens_out": self.tokens_out,
            "active": len(self.states),
            "ttft": _lat_stats(self.ttft_samples),
            "token": _lat_stats(self.token_samples),
            "kv": {"block_bytes": self.block_bytes,
                   "offload_events": self.kv_offload_events,
                   "offload_bytes": self.kv_offload_bytes,
                   "reload_events": self.kv_reload_events,
                   "reload_bytes": self.kv_reload_bytes,
                   "spills": self.kv_spills,
                   "peak_kv_bytes": dict(self.peak_kv)},
        }
