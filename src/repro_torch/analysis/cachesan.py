"""Runtime cache sanitizer ("cachesan") for the epoch-validated fast paths.

Source of truth: shadow-validation of every PR-7 cache against its retained
naive arm — ``_holders_cache`` / the inlined ``assignment_cost`` peer arm
vs ``assignment_cost_ref``, ``peer_source`` vs ``_peer_source_scan``,
``Executor._work_cache`` / ``_groups_cache`` vs the naive queue walk, and
the memoized transfer predictions vs their pure formulas. The static
epoch-discipline check (``repro_torch.analysis.checks``) proves every *registered*
mutation site bumps; cachesan is the dynamic detector for the bug class it
cannot prove absent — an unregistered mutation path serving a stale epoch.

At seeded-random probe points a probed call runs BOTH arms and raises
:class:`CacheDivergence` (with the divergent key, the residency epoch, and
both values) on any mismatch. Between probes the fast path runs untouched,
so a sanitized run still exercises the caches it is validating.

Enable with ``REPRO_CACHE_SANITIZE=1`` (rate via ``REPRO_CACHE_SANITIZE_RATE``,
seed via ``REPRO_CACHE_SANITIZE_SEED``) or per-spec with
``{"observability": {"sanitize": true}}``. Comparisons are exact (``==``,
never ``isclose``): the equivalence contract is bit-identical floats because
the cached arms preserve summation order.
"""
from __future__ import annotations

import os
import random
from typing import Any, Callable, Dict, List, Optional, Tuple

ENV_FLAG = "REPRO_CACHE_SANITIZE"
ENV_RATE = "REPRO_CACHE_SANITIZE_RATE"
ENV_SEED = "REPRO_CACHE_SANITIZE_SEED"
DEFAULT_RATE = 0.25
_TRUTHY = ("1", "true", "yes", "on")


class CacheDivergence(RuntimeError):
    """A cached value disagreed with its naive recompute."""

    def __init__(self, site: str, key: Any, epoch: Optional[int],
                 cached: Any, naive: Any):
        self.site = site
        self.key = key
        self.epoch = epoch
        self.cached = cached
        self.naive = naive
        super().__init__(
            f"cachesan: {site} diverged for key={key!r} at epoch={epoch}: "
            f"cached={cached!r} naive={naive!r} — an epoch-guarded mutation "
            "site is missing its bump (see docs/analysis.md)")


class CacheSanitizer:
    """Installable shadow-validator for one system's caches.

    Probe decisions come from a private seeded ``random.Random`` so a
    sanitized run is itself reproducible; the RNG is never the system's
    (sim semantics see no extra draws). ``install`` is idempotent per
    system and reversible via ``uninstall``.
    """

    def __init__(self, probe_rate: float = DEFAULT_RATE, seed: int = 0):
        if not 0.0 < probe_rate <= 1.0:
            raise ValueError(f"probe_rate must be in (0, 1]: {probe_rate}")
        self.probe_rate = probe_rate
        self.seed = seed
        self._rng = random.Random(seed)
        self._restore: List[Tuple[Any, str, Any]] = []
        self.probes = 0           # probed calls (both arms ran)
        self.calls = 0            # wrapped calls seen

    # ------------------------------------------------------------------ #
    def _probe(self) -> bool:
        self.calls += 1
        if self._rng.random() < self.probe_rate:
            self.probes += 1
            return True
        return False

    def _patch(self, obj: Any, name: str, wrapper: Callable) -> None:
        self._restore.append((obj, name, getattr(obj, name)))
        setattr(obj, name, wrapper)

    # ------------------------------------------------------------------ #
    def install(self, system: Any) -> "CacheSanitizer":
        if getattr(system, "_cachesan", None) is not None:
            return system._cachesan
        h = getattr(system, "hierarchy", None)
        if h is not None:
            self._wrap_hierarchy(h)
            self._wrap_transfer(h.transfer)
        for ex in getattr(system, "executors", ()):
            self._wrap_executor(ex)
        system._cachesan = self
        self._system = system
        return self

    def uninstall(self) -> None:
        for obj, name, orig in reversed(self._restore):
            setattr(obj, name, orig)
        self._restore.clear()
        sys_ = getattr(self, "_system", None)
        if sys_ is not None and getattr(sys_, "_cachesan", None) is self:
            sys_._cachesan = None

    # ------------------------------------------------------------------ #
    def _wrap_hierarchy(self, h: Any) -> None:
        san = self
        cost = h.assignment_cost          # bound originals
        cost_ref = h.assignment_cost_ref
        peer = h.peer_source
        peer_scan = h._peer_source_scan

        def assignment_cost(expert_id, now, group="", device=""):
            out = cost(expert_id, now, group, device)
            if san._probe():
                ref = cost_ref(expert_id, now, group, device)
                if out != ref:
                    raise CacheDivergence(
                        "hierarchy.assignment_cost (_holders_cache)",
                        (expert_id, group, device), h.epoch.n, out, ref)
            return out

        def peer_source(expert_id, dst_group):
            out = peer(expert_id, dst_group)
            if san._probe():
                ref = peer_scan(expert_id, dst_group) \
                    if h.topology.has_peer and dst_group in h.link_groups \
                    else None
                if out != ref:
                    raise CacheDivergence(
                        "hierarchy.peer_source (_holders_cache)",
                        (expert_id, dst_group), h.epoch.n, out, ref)
            return out

        self._patch(h, "assignment_cost", assignment_cost)
        self._patch(h, "peer_source", peer_source)

    def _wrap_transfer(self, t: Any) -> None:
        from repro_torch.memory.transfer import (predicted_load_latency,
                                           predicted_peer_copy_latency)
        san = self
        predict = t.predict
        predict_peer = t.predict_peer

        def predict_w(mem_bytes, in_host_cache):
            out = predict(mem_bytes, in_host_cache)
            if san._probe():
                ref = predicted_load_latency(t.spec, mem_bytes, in_host_cache)
                if out != ref:
                    raise CacheDivergence(
                        "transfer.predict (_pred_memo)",
                        (mem_bytes, in_host_cache), None, out, ref)
            return out

        def predict_peer_w(mem_bytes):
            out = predict_peer(mem_bytes)
            if san._probe():
                ref = predicted_peer_copy_latency(t.spec, mem_bytes)
                if out != ref:
                    raise CacheDivergence(
                        "transfer.predict_peer (_peer_memo)",
                        mem_bytes, None, out, ref)
            return out

        self._patch(t, "predict", predict_w)
        self._patch(t, "predict_peer", predict_peer_w)

    def _wrap_executor(self, ex: Any) -> None:
        san = self
        work = ex.queue_work
        groups = ex.queued_groups

        def queue_work():
            out = work()
            if san._probe():
                # flag-flip recompute: with ``use_pending_cache`` off,
                # ``_residency_epoch()`` is None, so the original method
                # runs its naive loop and stores nothing — side-effect free
                flag = ex.use_pending_cache
                ex.use_pending_cache = False
                try:
                    ref = work()
                finally:
                    ex.use_pending_cache = flag
                if out != ref:
                    epoch = ex._residency_epoch()
                    raise CacheDivergence(
                        f"executor[{ex.id}].queue_work (_work_cache)",
                        ("queue.version", ex.queue.version),
                        epoch.n if epoch is not None else None, out, ref)
            return out

        def queued_groups():
            out = groups()
            if san._probe():
                ref: Dict[str, int] = {}
                for g in ex.queue:
                    ref[g.expert_id] = ref.get(g.expert_id, 0) + 1
                if out != ref:
                    raise CacheDivergence(
                        f"executor[{ex.id}].queued_groups (_groups_cache)",
                        ("queue.version", getattr(ex.queue, "version", None)),
                        None, out, ref)
            return out

        self._patch(ex, "queue_work", queue_work)
        self._patch(ex, "queued_groups", queued_groups)


# ---------------------------------------------------------------------- #
# activation hooks
# ---------------------------------------------------------------------- #

def env_enabled() -> bool:
    return os.environ.get(ENV_FLAG, "").strip().lower() in _TRUTHY


def install_from_env(system: Any) -> Optional[CacheSanitizer]:
    """Install on ``system`` iff ``REPRO_CACHE_SANITIZE`` is truthy.
    Called from ``CoServeSystem.__init__`` so every system built anywhere
    (tests, benchmarks, serve CLI) is covered without plumbing."""
    if not env_enabled():
        return None
    rate = float(os.environ.get(ENV_RATE, DEFAULT_RATE))
    seed = int(os.environ.get(ENV_SEED, "0"))
    return CacheSanitizer(probe_rate=rate, seed=seed).install(system)


def sanitizer_self_test(system: Any) -> bool:
    """Inject a stale-epoch fault and verify the sanitizer catches it.

    Corrupts one executor's ``_work_cache`` entry in place (valid queue
    version and epoch, wrong value — exactly what a missed bump produces)
    and asserts the next probed ``queue_work`` raises. Restores the
    system's original methods before returning. True iff the fault was
    detected; False means the sanitizer is NOT protecting this system
    (no epoch-cacheable executor, or detection failed)."""
    if getattr(system, "_cachesan", None) is not None:
        return False            # refuse to displace an active sanitizer
    ex = next((e for e in getattr(system, "executors", ())
               if e._residency_epoch() is not None), None)
    if ex is None:
        return False
    san = CacheSanitizer(probe_rate=1.0, seed=0)
    san.install(system)
    try:
        good = ex.queue_work()             # primes a valid cache entry
        qv, en, _ = ex._work_cache
        ex._work_cache = (qv, en, good + 1.0)
        try:
            ex.queue_work()
        except CacheDivergence:
            return True
        return False
    finally:
        ex._work_cache = (-1, -1, 0.0)
        san.uninstall()
