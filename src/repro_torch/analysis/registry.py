"""Declared exemptions and invariant registries for ``repro_torch.analysis``.

Source of truth: the ONLY place an invariant-analyzer exemption on the
port's package may live. The checks (``repro_torch.analysis.checks``, the
reference's with the package renamed) are deliberately strict; everything
the port's tree legitimately does against the letter of a rule is declared
here as one reviewable line with a reason. An entry that stops matching
anything is reported as stale (an error under ``--strict``), so the
registry can never silently outlive the code it excuses.

The reference's registry, renamed, with the port's own measurement sites:
the dry run's trace seconds (``launch.dryrun.trace_step``) in place of the
reference's lower/compile seconds, and the LM router's offline profile of
a real batch (``launch.lm_coe_router.build_lm_system``).

Four registries:

  ``ALLOWLIST``       per-check (module, qualname-prefix) exemptions — the
                      legitimate wall-clock measurement sites, the one
                      queue-mutation helper whose callers bump, etc.
  ``EPOCH_CLASSES``   the version-counter discipline itself: which classes
                      own epoch-guarded state, which fields constitute that
                      state, what counts as the bump, and which methods are
                      exempt (with reasons).
  ``EPOCH_FIELDS``    attribute names that are epoch-guarded state wherever
                      they are mutated (cross-module: ``pool.kv_bytes`` in
                      the decode runtime must bump the pool's epoch).
  ``TRACE_HELPERS``   functions whose *internal* ``emit`` is exempt from the
                      guard-domination rule because every call site carries
                      the guard — calls to these helpers are then checked
                      exactly like raw ``emit`` calls.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple


@dataclasses.dataclass(frozen=True)
class Exemption:
    """One declared, reviewable escape hatch for one check.

    ``qualname`` is a prefix: ``"build_real_system"`` covers the profiling
    closures nested inside it (``build_real_system.run_batch_factory.
    run_batch``), ``"RealEngine"`` covers every method of the class.
    """
    check: str           # which check this exempts ("wallclock", "epoch", ...)
    module: str          # dotted module, e.g. "repro_torch.core.simulator"
    qualname: str        # qualname prefix within the module ("" = whole module)
    reason: str          # why this is legitimate — shown in --explain output


# --------------------------------------------------------------------------- #
# determinism lint: legitimate wall-clock measurement sites.
#
# The rule: sim *semantics* (anything a scheduling decision or a metric that
# must be bit-identical across runs can observe) never reads the wall clock.
# Wall time may only be *measured and reported* — Metrics.wall_s, overhead
# accounting (Fig. 19), real-engine transfer/forward timing, offline
# profiling, and search time budgets (which bound effort, not decisions:
# the returned cost is always an exact replay, budget or not).
# --------------------------------------------------------------------------- #
ALLOWLIST: Tuple[Exemption, ...] = (
    Exemption("wallclock", "repro_torch.core.simulator", "Simulation.run",
              "Metrics.wall_s: measured wall time of the run loop"),
    Exemption("wallclock", "repro_torch.core.simulator", "run_real",
              "real-mode makespan is measured wall time, not sim time"),
    Exemption("wallclock", "repro_torch.core.executor", "Executor.start_load",
              "ExecStats.mgmt_time: eviction-decision overhead (Fig. 19)"),
    Exemption("wallclock", "repro_torch.core.serving", "CoServeSystem.assign",
              "Metrics.sched_time: scheduling overhead (Fig. 19)"),
    Exemption("wallclock", "repro_torch.core.engines", "RealEngine",
              "real backend: measured transfer / forward wall time"),
    Exemption("wallclock", "repro_torch.api.build", "build_real_system",
              "offline profiling measures real jitted forwards (§4.5)"),
    Exemption("wallclock", "repro_torch.fleet.search", "search_placement",
              "time_budget_s bounds search effort, never the result "
              "(the reported cost is an exact replay either way)"),
    Exemption("wallclock", "repro_torch.launch.dryrun", "trace_step",
              "reports the trace's wall time (lower_s) of a dry-run step"),
    Exemption("wallclock", "repro_torch.launch.lm_coe_router",
              "build_lm_system",
              "offline profiling measures a real expert batch after a "
              "device sync (§4.5)"),
    Exemption("wallclock", "repro_torch.launch.train", "main",
              "training throughput measurement (tokens/sec)"),
    Exemption("wallclock", "repro_torch.analysis.__main__", "main",
              "the analyzer reports its own wall time; not sim semantics"),
    Exemption("wallclock", "repro_torch.obs.tracer", "Tracer",
              "a wall tracer stamps its events for the card's trace; no "
              "sim decision reads the stamps"),
    # epoch-discipline: the one mutation site whose bump lives in callers
    Exemption("epoch", "repro_torch.core.scheduler", "split_batch",
              "both call sites (Executor.start_next_batch, decode admit) "
              "bump the owning queue immediately after the split — the "
              "helper has no queue reference to bump"),
)


# --------------------------------------------------------------------------- #
# epoch-discipline: the cache-coherence rule, as data.
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class EpochClass:
    """One class whose state is epoch-guarded: any method that mutates a
    ``field`` (attribute assignment / augmented assignment / subscript store
    / del / mutating container-method call on ``self.<field>``, or a
    ``super().<mutator>()`` call for container subclasses) must also execute
    the declared ``bump`` in the same method."""
    module: str
    cls: str
    fields: Tuple[str, ...]           # guarded attributes of self
    super_mutators: Tuple[str, ...]   # super() calls that mutate (subclasses)
    bump: str                         # human-readable bump description
    bump_attrs: Tuple[str, ...]       # attribute paths that count as the bump
    #                                 # ("epoch.bump" matches self.epoch.bump())
    exempt: Mapping[str, str]         # method -> reason


_CONTAINER_MUTATORS = ("add", "discard", "remove", "pop", "clear", "update",
                       "difference_update", "intersection_update",
                       "symmetric_difference_update", "append", "insert",
                       "extend", "__delitem__", "__setitem__", "__iadd__",
                       "popitem", "setdefault")

EPOCH_CLASSES: Tuple[EpochClass, ...] = (
    EpochClass(
        module="repro_torch.memory.residency", cls="DevicePool",
        fields=("resident", "insert_seq", "used_bytes", "kv_bytes"),
        super_mutators=(),
        bump="self.epoch.bump()", bump_attrs=("epoch.bump",),
        exempt={
            "__init__": "construction precedes any cached reads",
            "touch": "LRU touch reorders eviction, never changes load cost",
        }),
    EpochClass(
        module="repro_torch.memory.residency", cls="HostTier",
        fields=("resident", "insert_seq", "used_bytes", "ready_at"),
        super_mutators=(),
        bump="self.epoch.bump()", bump_attrs=("epoch.bump",),
        exempt={
            "__init__": "construction precedes any cached reads",
            "touch": "LRU touch reorders eviction, never changes load cost",
        }),
    EpochClass(
        module="repro_torch.memory.residency", cls="ReadySet",
        fields=(),
        super_mutators=_CONTAINER_MUTATORS,
        bump="self.epoch.bump()", bump_attrs=("epoch.bump",),
        exempt={"__init__": "construction precedes any cached reads"}),
    EpochClass(
        module="repro_torch.core.executor", cls="TrackedQueue",
        fields=(),
        super_mutators=_CONTAINER_MUTATORS,
        bump="self.version += 1", bump_attrs=("version",),
        exempt={"__init__": "construction precedes any cached reads"}),
)
# HostTier.insert bumps inside its success branch only; the check is
# function-granular (a bump anywhere in the method satisfies it), so no
# exemption is needed for it.


# Cross-module epoch-guarded attribute names: a mutation of ``<base>.<name>``
# in any scoped module (outside the owning classes above) must be paired
# with an epoch/version bump in the same function. ``requests`` covers the
# in-place Group grow/shrink sites (arrange joins, batch splits), whose bump
# is ``bump_queue(...)`` / ``queue.bump()``.
EPOCH_FIELDS: Dict[str, str] = {
    "kv_bytes": "DevicePool KV-byte accounting (decode runtime)",
    "used_bytes": "tier byte accounting",
    "resident": "tier membership",
    "insert_seq": "tier insertion order",
    "requests": "in-place Group mutation (must bump the owning queue)",
}

# Calls that satisfy the cross-module bump requirement: any attribute call
# path ending in one of these, or a bare call to one of these names.
EPOCH_BUMP_CALLS = ("bump",)          # pool.epoch.bump(), queue.bump()
EPOCH_BUMP_FUNCS = ("bump_queue",)    # repro_torch.core.scheduler.bump_queue


# --------------------------------------------------------------------------- #
# tracer-guard lint: registered trace helpers.
#
# ``TransferEngine._trace`` centralizes the per-leg xfer event but carries
# no guard itself — every CALL site holds the ``tracer.enabled`` fast guard
# (one boolean test instead of re-reading it per leg). Registering it here
# exempts the helper's internal ``emit`` and transfers the guard requirement
# to its call sites, which the check then enforces like raw emits.
# --------------------------------------------------------------------------- #
TRACE_HELPERS: Dict[Tuple[str, str], str] = {
    ("repro_torch.memory.transfer", "TransferEngine._trace"):
        "per-leg xfer emitter; every call site carries the enabled guard",
}


def exemptions_for(check: str) -> Tuple[Exemption, ...]:
    return tuple(e for e in ALLOWLIST if e.check == check)
