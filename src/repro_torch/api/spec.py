"""DeploymentSpec: one declarative, serializable config for every run.

Source of truth: the only user-facing description of a CoServe deployment —
what model catalog to serve (``ModelSpec``), on what fleet shape
(``FleetSection``), over which storage hierarchy (``MemorySection``), with
which scheduling/eviction policy (``PolicySection``), through which serving
mode (``ServingSection``), under what traffic (``WorkloadSection``).
``repro_torch.api.build.build_system`` turns a spec into a ``CoServeSystem``;
``repro_torch.api.session.Session`` runs it; ``repro_torch.launch.serve`` is a thin
flag -> spec adapter on top.

Design contract (pinned by tests):

  * frozen dataclasses, validated eagerly — a constructed spec is a valid
    spec, and every validation error says which field and what to do;
  * lossless serialization — ``DeploymentSpec.from_dict(s.to_dict()) == s``
    for any spec, and ``save``/``load`` round-trips through JSON byte-stably,
    so a run's full configuration is a reproducible, diffable artifact
    (the SN40L "whole allocation as one compiled artifact" argument);
  * strict parsing — unknown keys are rejected with the known-key list, so
    a typo'd field fails loudly instead of silently using a default.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.memory.policies import POLICY_NAMES
from repro_torch.memory.tiers import LINK_MODES
from repro_torch.obs.tracer import DEFAULT_CAPACITY, TRACE_LEVELS
from repro_torch.serve.arrivals import PROCESSES, REQUEST_CLASSES

MODES = ("sim", "real", "online")
ENGINES = ("sim", "real")
MODEL_KINDS = ("board", "tenants", "tiny")
TIER_PRESETS = ("numa", "uma", "tpu_v5e")
PREFETCH_MODES = (None, "off", "device", "all")
PREFETCH_TRIGGERS = (None, "exec", "queue")
PLACEMENTS = ("greedy", "search", "plan")
ADMISSIONS = ("none", "queue_depth", "deadline", "token_bucket")
POLICY_PRESETS = ("coserve", "coserve_none", "samba", "samba_fifo",
                  "samba_parallel")
PRESET_BOARD_NAMES = ("A", "B")

SCHEMA_VERSION = 1


class SpecError(ValueError):
    """A DeploymentSpec field (or combination) is invalid. The message
    always names the offending ``section.field`` and what to change."""


def _check(cond: bool, where: str, msg: str):
    if not cond:
        raise SpecError(f"{where}: {msg}")


def _choice(value, where: str, choices):
    shown = [c for c in choices if c is not None]
    _check(value in choices, where,
           f"got {value!r}, expected one of {shown}"
           + (" (or omit it)" if None in choices else ""))


# --------------------------------------------------------------------------- #
# serialization machinery (shared by every section)
# --------------------------------------------------------------------------- #

def _to_jsonable(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return [_to_jsonable(v) for v in obj]
    return obj


# field -> cast applied on from_dict (None values pass through untouched for
# Optional fields; nested sections declare their class instead of a cast)
_CASTS = {int: lambda v: int(v), float: lambda v: float(v),
          str: lambda v: str(v), bool: lambda v: bool(v)}


def _section_from_dict(cls, d: Mapping, where: str):
    """Strict dict -> section: unknown keys fail with the known-key list,
    missing keys take the field default, scalars are cast to the declared
    type (so hand-written JSON ``25`` satisfies a float field)."""
    if not isinstance(d, Mapping):
        raise SpecError(f"{where}: expected an object, got {type(d).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - set(fields))
    if unknown:
        raise SpecError(
            f"{where}: unknown key(s) {unknown} — known keys: "
            f"{sorted(fields)}")
    kwargs = {}
    types = cls._FIELD_TYPES
    for name, value in d.items():
        spec_t = types[name]
        path = f"{where}.{name}"
        if value is None:
            kwargs[name] = None
            continue
        if isinstance(spec_t, tuple):          # (element_type,): tuple field
            elem = spec_t[0]
            if not isinstance(value, (list, tuple)):
                raise SpecError(f"{path}: expected a list")
            if dataclasses.is_dataclass(elem):
                kwargs[name] = tuple(
                    _section_from_dict(elem, v, f"{path}[{i}]")
                    for i, v in enumerate(value))
            else:
                try:
                    kwargs[name] = tuple(_CASTS[elem](v) for v in value)
                except (TypeError, ValueError):
                    raise SpecError(
                        f"{path}: expected a list of "
                        f"{elem.__name__}") from None
        elif dataclasses.is_dataclass(spec_t):
            kwargs[name] = _section_from_dict(spec_t, value, path)
        else:
            try:
                kwargs[name] = _CASTS[spec_t](value)
            except (TypeError, ValueError):
                raise SpecError(
                    f"{path}: cannot read {value!r} as "
                    f"{spec_t.__name__}") from None
    try:
        return cls(**kwargs)
    except SpecError:
        raise
    except (TypeError, ValueError) as e:
        raise SpecError(f"{where}: {e}") from None


class _Section:
    """Shared to_dict/from_dict surface. Subclasses set ``_FIELD_TYPES``:
    field -> python scalar type, nested section class, or 1-tuple of the
    element class for tuple-of-section fields."""
    _FIELD_TYPES: Dict[str, object] = {}

    def to_dict(self) -> dict:
        return _to_jsonable(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "_Section":
        return _section_from_dict(cls, d, cls.__name__)


# --------------------------------------------------------------------------- #
# sections
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class BoardSection(_Section):
    """A custom circuit-board catalog (mirrors ``workload.BoardSpec``) —
    declared once under ``model.boards`` and referenced by name from
    ``model.board`` or ``workload.tenants[].board``."""
    name: str
    n_components: int
    n_active: int = 120
    avg_quantity: float = 3.0
    n_detection: int = 24
    detection_fraction: float = 0.4
    ok_prob: float = 0.95
    zipf_s: float = 1.1

    _FIELD_TYPES = {"name": str, "n_components": int, "n_active": int,
                    "avg_quantity": float, "n_detection": int,
                    "detection_fraction": float, "ok_prob": float,
                    "zipf_s": float}

    def __post_init__(self):
        _check(bool(self.name), "model.boards[].name", "must be non-empty")
        _check(self.name not in PRESET_BOARD_NAMES, "model.boards[].name",
               f"{self.name!r} shadows the built-in board "
               f"{PRESET_BOARD_NAMES} — pick another name")
        _check(self.n_components >= 1, f"model.boards[{self.name}]",
               "n_components must be >= 1")
        _check(1 <= self.n_active <= self.n_components,
               f"model.boards[{self.name}]",
               f"n_active must be in [1, n_components={self.n_components}]")
        _check(self.n_detection >= 1, f"model.boards[{self.name}]",
               "n_detection must be >= 1")


@dataclasses.dataclass(frozen=True)
class ModelSpec(_Section):
    """What expert catalog to serve.

    ``kind="board"``   one circuit board (``board`` names a preset A/B or a
                       custom entry in ``boards``) — the paper's sim workload.
    ``kind="tenants"`` the union catalog of every ``workload.tenants[]``
                       board, usage-weighted by tenant rate (or by
                       ``tenant_weights`` when the provisioning assumption
                       deliberately differs from the traffic).
    ``kind="tiny"``    the small real-JAX MLP catalog (host/disk tiers,
                       jitted forwards) — ``--mode real`` / ``--engine real``.
    """
    kind: str = "board"
    board: str = "A"
    boards: Tuple[BoardSection, ...] = ()
    tenant_weights: Tuple[float, ...] = ()   # kind="tenants": provisioning
    #                                          weights; empty = tenant rates
    # kind="tiny" catalog knobs (defaults = launch.serve real mode)
    tiny_components: int = 24
    tiny_detection: int = 4
    tiny_pool_experts: int = 6
    tiny_executors: int = 2
    tiny_d_hidden: int = 256

    _FIELD_TYPES = {"kind": str, "board": str, "boards": (BoardSection,),
                    "tenant_weights": (float,), "tiny_components": int,
                    "tiny_detection": int, "tiny_pool_experts": int,
                    "tiny_executors": int, "tiny_d_hidden": int}

    def __post_init__(self):
        _choice(self.kind, "model.kind", MODEL_KINDS)
        names = [b.name for b in self.boards]
        _check(len(names) == len(set(names)), "model.boards",
               f"duplicate board names in {names}")
        for f in ("tiny_components", "tiny_detection", "tiny_pool_experts",
                  "tiny_executors", "tiny_d_hidden"):
            _check(getattr(self, f) >= 1, f"model.{f}", "must be >= 1")
        object.__setattr__(self, "tenant_weights",
                           tuple(float(w) for w in self.tenant_weights))
        _check(all(w > 0 for w in self.tenant_weights),
               "model.tenant_weights", "weights must be positive")

    def board_names(self) -> Tuple[str, ...]:
        return tuple(b.name for b in self.boards) + PRESET_BOARD_NAMES


@dataclasses.dataclass(frozen=True)
class FleetSection(_Section):
    """Fleet shape + expert placement policy (``repro_torch.fleet``)."""
    devices: int = 1
    gpu_per_device: int = 3
    cpu: int = 1
    links: str = "shared"            # shared | per-device
    replication: int = 0             # planned copies of the hottest experts
    peer_bw_gbps: float = 0.0        # NVLink/ICI-class pool->pool fabric
    placement: str = "greedy"        # greedy | search | plan
    trace_path: str = ""             # search: replay this saved WorkloadTrace
    #                                  instead of deriving one from the spec
    plan_path: str = ""              # plan: apply this saved PlacementPlan

    _FIELD_TYPES = {"devices": int, "gpu_per_device": int, "cpu": int,
                    "links": str, "replication": int, "peer_bw_gbps": float,
                    "placement": str, "trace_path": str, "plan_path": str}

    def __post_init__(self):
        _check(self.devices >= 1, "fleet.devices", "must be >= 1")
        _check(self.gpu_per_device >= 0 and self.cpu >= 0,
               "fleet.gpu_per_device/cpu", "executor counts must be >= 0")
        _choice(self.links, "fleet.links", LINK_MODES)
        _check(self.replication >= 0, "fleet.replication", "must be >= 0")
        _check(self.peer_bw_gbps >= 0, "fleet.peer_bw_gbps", "must be >= 0")
        _choice(self.placement, "fleet.placement", PLACEMENTS)
        _check(not (self.placement == "plan" and not self.plan_path),
               "fleet.plan_path",
               'placement="plan" needs the path of a saved placement plan '
               "(repro_torch.api.save_plan / serve --save-plan)")
        _check(not (self.plan_path and self.placement != "plan"),
               "fleet.plan_path",
               f'only read when placement="plan" (got '
               f'placement={self.placement!r}) — remove it or switch')
        _check(not (self.trace_path and self.placement != "search"),
               "fleet.trace_path",
               f'only read when placement="search" (got '
               f'placement={self.placement!r}) — remove it or switch')

    def is_default_shape(self) -> bool:
        """True when no fleet/placement knob deviates from the single-device
        shared-link paper topology (the only shape real engines support)."""
        return (self.devices == 1 and self.links == "shared"
                and not self.replication and not self.peer_bw_gbps
                and self.placement == "greedy")


@dataclasses.dataclass(frozen=True)
class MemorySection(_Section):
    """Storage-hierarchy numbers + cross-tier prefetch behaviour. ``tier``
    names a preset (numa | uma | tpu_v5e); any explicit field overrides the
    preset's value (``repro_torch.memory.TierSpec``). Bandwidths are bytes/sec."""
    tier: str = "numa"
    name: str = ""                         # override TierSpec.name
    disk_bw: Optional[float] = None
    host_to_device_bw: Optional[float] = None
    host_overhead: Optional[float] = None
    disk_overhead: Optional[float] = None
    host_cache_bytes: Optional[int] = None
    device_bytes: Optional[int] = None
    unified: Optional[bool] = None
    prefetch: Optional[str] = None         # off | device | all | None=policy
    prefetch_trigger: Optional[str] = None  # exec | queue | None=policy

    _FIELD_TYPES = {"tier": str, "name": str, "disk_bw": float,
                    "host_to_device_bw": float, "host_overhead": float,
                    "disk_overhead": float, "host_cache_bytes": int,
                    "device_bytes": int, "unified": bool, "prefetch": str,
                    "prefetch_trigger": str}

    def __post_init__(self):
        _choice(self.tier, "memory.tier", TIER_PRESETS)
        _choice(self.prefetch, "memory.prefetch", PREFETCH_MODES)
        _choice(self.prefetch_trigger, "memory.prefetch_trigger",
                PREFETCH_TRIGGERS)
        for f in ("disk_bw", "host_to_device_bw"):
            v = getattr(self, f)
            _check(v is None or v > 0, f"memory.{f}", "must be positive")
        for f in ("host_overhead", "disk_overhead", "host_cache_bytes",
                  "device_bytes"):
            v = getattr(self, f)
            _check(v is None or v >= 0, f"memory.{f}", "must be >= 0")


@dataclasses.dataclass(frozen=True)
class PolicySection(_Section):
    """System policy: a named preset (paper systems) + targeted overrides."""
    name: str = "coserve"
    evict: Optional[str] = None      # eviction policy override (e.g.
    #                                  "observed": rank victims by live load)

    _FIELD_TYPES = {"name": str, "evict": str}

    def __post_init__(self):
        _choice(self.name, "policy.name", POLICY_PRESETS)
        _choice(self.evict, "policy.evict", (None,) + POLICY_NAMES)


@dataclasses.dataclass(frozen=True)
class HeteroSection(_Section):
    """Heterogeneous CPU co-execution: host-DRAM-resident experts execute in
    place on the CPU executors instead of stalling on a disk/PCIe load, and
    the scheduler prices min(execute_on_host, load_then_execute_on_device)
    per arrival. Off by default — every cost and decision stream is then
    bit-identical to the cache-only host tier."""
    host_exec: bool = False          # run host-resident experts on the CPU
    cpu_multiplier: float = 0.0      # sim: derive the CPU service-time model
    #                                  as device-time x this (0 = the static
    #                                  measured CPU constants; real mode
    #                                  measures via run_batch_cpu instead)
    host_place: bool = False         # placement search may plan deliberate
    #                                  CPU residents (the host_place move);
    #                                  needs fleet.placement="search"

    _FIELD_TYPES = {"host_exec": bool, "cpu_multiplier": float,
                    "host_place": bool}

    def __post_init__(self):
        _check(self.cpu_multiplier >= 0, "hetero.cpu_multiplier",
               "must be >= 0 (0 uses the static CPU constants)")
        _check(not (self.host_place and not self.host_exec),
               "hetero.host_place",
               "planning deliberate CPU residents only pays off when they "
               "can execute in place — set hetero.host_exec=true too")


@dataclasses.dataclass(frozen=True)
class DecodeSection(_Section):
    """Token-level continuous batching with paged KV residency
    (``repro_torch.core.decode``). Off by default — every decision stream and
    metric is then bit-identical to the stage-level simulation. When on,
    a request's terminal stage becomes prefill + a per-token decode loop,
    and its KV blocks occupy device bytes next to expert weights."""
    enabled: bool = False
    tokens: int = 24                 # mean generated tokens per request
    tokens_dist: str = "fixed"       # fixed | geometric
    block_tokens: int = 16           # tokens per paged KV block
    token_bytes: int = 262144        # KV bytes per token across layers
    kv_budget_fraction: float = 0.5  # max pool fraction KV may occupy
    kv_evict: str = "kv_aware"       # kv_aware | weight_only
    max_decode_batch: int = 8        # continuous-batch membership cap
    step_k: float = 0.002            # per-member seconds per decode step
    step_b: float = 0.0005           # fixed per-step overhead seconds

    _FIELD_TYPES = {"enabled": bool, "tokens": int, "tokens_dist": str,
                    "block_tokens": int, "token_bytes": int,
                    "kv_budget_fraction": float, "kv_evict": str,
                    "max_decode_batch": int, "step_k": float,
                    "step_b": float}

    def __post_init__(self):
        _check(self.tokens >= 1, "decode.tokens", "must be >= 1")
        _choice(self.tokens_dist, "decode.tokens_dist",
                ("fixed", "geometric"))
        _check(self.block_tokens >= 1, "decode.block_tokens", "must be >= 1")
        _check(self.token_bytes >= 1, "decode.token_bytes", "must be >= 1")
        _check(0 < self.kv_budget_fraction <= 1,
               "decode.kv_budget_fraction", "must be in (0, 1]")
        _choice(self.kv_evict, "decode.kv_evict",
                ("kv_aware", "weight_only"))
        _check(self.max_decode_batch >= 1, "decode.max_decode_batch",
               "must be >= 1")
        _check(self.step_k >= 0, "decode.step_k", "must be >= 0")
        _check(self.step_b >= 0, "decode.step_b", "must be >= 0")


@dataclasses.dataclass(frozen=True)
class ServingSection(_Section):
    """How requests reach the system: batch sim, real JAX execution, or the
    streaming online gateway with admission/SLO/autoscaling."""
    mode: str = "sim"                # sim | real | online
    engine: str = "sim"              # online mode: sim | real
    admission: str = "none"          # none | queue_depth | deadline |
    #                                  token_bucket
    max_queue: int = 200
    bucket_rate: Optional[float] = None
    bucket_burst: float = 50.0
    autoscale: str = "auto"          # "min,max" | "auto" | "none"
    slo_priority: bool = True
    tick: float = 0.5

    _FIELD_TYPES = {"mode": str, "engine": str, "admission": str,
                    "max_queue": int, "bucket_rate": float,
                    "bucket_burst": float, "autoscale": str,
                    "slo_priority": bool, "tick": float}

    def __post_init__(self):
        _choice(self.mode, "serving.mode", MODES)
        _choice(self.engine, "serving.engine", ENGINES)
        _choice(self.admission, "serving.admission", ADMISSIONS)
        _check(self.max_queue >= 1, "serving.max_queue", "must be >= 1")
        _check(self.bucket_rate is None or self.bucket_rate > 0,
               "serving.bucket_rate", "must be positive")
        _check(self.bucket_burst > 0, "serving.bucket_burst",
               "must be positive")
        _check(self.tick > 0, "serving.tick", "must be positive")
        self.autoscale_bounds(fleet_size=1)   # eager format check

    def autoscale_bounds(self, fleet_size: int):
        """(min, max) executors, or None when scaling is disabled."""
        if self.autoscale == "none":
            return None
        if self.autoscale == "auto":
            return (fleet_size, 2 * fleet_size)
        try:
            lo, hi = map(int, self.autoscale.split(","))
        except ValueError:
            raise SpecError(
                f"serving.autoscale: expected 'min,max', 'auto' or 'none', "
                f"got {self.autoscale!r}") from None
        _check(0 < lo <= hi, "serving.autoscale",
               f"need 0 < min <= max, got {lo},{hi}")
        return (lo, hi)


@dataclasses.dataclass(frozen=True)
class TenantSection(_Section):
    """One traffic source (mirrors ``repro_torch.serve.TenantSpec``). ``seed``
    defaults to the spec-level seed plus the tenant's position."""
    name: str
    board: str = "A"
    rate: float = 25.0
    arrival: str = "poisson"         # poisson | bursty | diurnal | step
    request_class: str = "scan"      # scan | random
    slo_seconds: float = 2.0
    seed: Optional[int] = None

    _FIELD_TYPES = {"name": str, "board": str, "rate": float, "arrival": str,
                    "request_class": str, "slo_seconds": float, "seed": int}

    def __post_init__(self):
        _check(bool(self.name), "workload.tenants[].name",
               "must be non-empty")
        _choice(self.arrival, f"workload.tenants[{self.name}].arrival",
                PROCESSES)
        _choice(self.request_class,
                f"workload.tenants[{self.name}].request_class",
                REQUEST_CLASSES)
        _check(self.rate > 0, f"workload.tenants[{self.name}].rate",
               "must be positive")
        _check(self.slo_seconds > 0,
               f"workload.tenants[{self.name}].slo_seconds",
               "must be positive")


@dataclasses.dataclass(frozen=True)
class WorkloadSection(_Section):
    """Offered traffic: total request budget, the sim-mode arrival cadence,
    and the online tenant mix."""
    requests: int = 2500
    interval_s: float = 0.004        # sim-mode inter-arrival (paper: 4 ms)
    tenants: Tuple[TenantSection, ...] = ()

    _FIELD_TYPES = {"requests": int, "interval_s": float,
                    "tenants": (TenantSection,)}

    def __post_init__(self):
        _check(self.requests >= 1, "workload.requests", "must be >= 1")
        _check(self.interval_s > 0, "workload.interval_s", "must be positive")
        names = [t.name for t in self.tenants]
        _check(len(names) == len(set(names)), "workload.tenants",
               f"duplicate tenant names in {names} — per-tenant SLOs and "
               "telemetry are keyed by name")


@dataclasses.dataclass(frozen=True)
class ObservabilitySection(_Section):
    """Flight-recorder settings (``repro_torch.obs``). ``trace="summary"`` records
    memory-system events (loads/evictions/transfers/sheds/scales);
    ``"full"`` adds per-request events (assign/sched/exec/admit), enough to
    reconstruct per-request timelines. ``trace_path`` auto-exports the ring
    buffer as Chrome trace JSON after ``Session.run``."""
    trace: str = "off"               # off | summary | full
    buffer_events: int = DEFAULT_CAPACITY   # ring-buffer capacity
    trace_path: str = ""             # export target ("" = no auto-export)
    sanitize: bool = False           # cachesan: shadow-validate the
    #                                  epoch-guarded caches against naive
    #                                  recompute (debug; see docs/analysis.md)

    _FIELD_TYPES = {"trace": str, "buffer_events": int, "trace_path": str,
                    "sanitize": bool}

    def __post_init__(self):
        _choice(self.trace, "observability.trace", TRACE_LEVELS)
        _check(self.buffer_events >= 1, "observability.buffer_events",
               "must be >= 1")
        _check(not (self.trace_path and self.trace == "off"),
               "observability.trace_path",
               'set trace="summary" or "full" to record events '
               "(trace_path has nothing to export at trace=\"off\")")


# --------------------------------------------------------------------------- #
# the spec
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class DeploymentSpec(_Section):
    """One deployment, declaratively. See docs/configuration.md for the
    full schema and one annotated example per mode."""
    model: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    fleet: FleetSection = dataclasses.field(default_factory=FleetSection)
    memory: MemorySection = dataclasses.field(default_factory=MemorySection)
    policy: PolicySection = dataclasses.field(default_factory=PolicySection)
    serving: ServingSection = dataclasses.field(
        default_factory=ServingSection)
    workload: WorkloadSection = dataclasses.field(
        default_factory=WorkloadSection)
    observability: ObservabilitySection = dataclasses.field(
        default_factory=ObservabilitySection)
    hetero: HeteroSection = dataclasses.field(default_factory=HeteroSection)
    decode: DecodeSection = dataclasses.field(default_factory=DecodeSection)
    seed: int = 0
    version: int = SCHEMA_VERSION

    _FIELD_TYPES = {"model": ModelSpec, "fleet": FleetSection,
                    "memory": MemorySection, "policy": PolicySection,
                    "serving": ServingSection, "workload": WorkloadSection,
                    "observability": ObservabilitySection,
                    "hetero": HeteroSection, "decode": DecodeSection,
                    "seed": int, "version": int}

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        _check(self.version == SCHEMA_VERSION, "version",
               f"this build reads DeploymentSpec schema v{SCHEMA_VERSION}, "
               f"got v{self.version}")
        mode, engine = self.serving.mode, self.serving.engine
        kind = self.model.kind
        real_exec = mode == "real" or (mode == "online" and engine == "real")

        if mode == "sim":
            _check(kind in ("board", "tenants"), "model.kind",
                   f'serving.mode="sim" serves a board catalog — use '
                   f'kind="board" (or "tenants" for a multi-board catalog '
                   f'driven by workload.tenants), got {kind!r}')
        elif mode == "real":
            _check(kind == "tiny", "model.kind",
                   f'serving.mode="real" runs the tiny real-JAX catalog — '
                   f'set kind="tiny", got {kind!r}')
        elif engine == "sim":
            _check(kind == "tenants", "model.kind",
                   f'serving.mode="online" with the sim engine serves the '
                   f'tenant mix — set kind="tenants", got {kind!r}')
        else:
            _check(kind == "tiny", "model.kind",
                   f'serving.engine="real" serves the tiny real-JAX catalog '
                   f'— set kind="tiny", got {kind!r}')

        if kind == "tenants" or (mode == "online" and engine == "real"):
            _check(len(self.workload.tenants) >= 1, "workload.tenants",
                   "this mode needs at least one tenant")
        if mode == "online" and engine == "real":
            _check(len(self.workload.tenants) == 1, "workload.tenants",
                   'serving.engine="real" serves a single tenant over the '
                   "tiny local CoE (multi-tenant mixes need the sim engine)")
        _check(not (real_exec and not self.fleet.is_default_shape()),
               "fleet",
               "devices/links/replication/peer_bw_gbps/placement drive the "
               'simulated fleet; serving.mode="real" and engine="real" run '
               "the single-device shared-link topology")

        if self.hetero.host_exec and kind != "tiny":
            _check(self.fleet.cpu >= 1, "hetero.host_exec",
                   "host co-execution needs at least one CPU executor — "
                   f"set fleet.cpu >= 1 (got {self.fleet.cpu})")
            _check(self.policy.name not in ("samba", "samba_fifo"),
                   "hetero.host_exec",
                   f"the single-executor baseline {self.policy.name!r} "
                   "normalizes to one device executor and can never route "
                   "to the CPU — use a multi-executor policy")
        _check(not (self.hetero.host_place
                    and self.fleet.placement != "search"),
               "hetero.host_place",
               "deliberate CPU residents are planned by the placement "
               f'search — set fleet.placement="search" (got '
               f"{self.fleet.placement!r})")

        _check(not (self.decode.enabled and mode == "online"),
               "decode.enabled",
               "token-level decode drives the offline simulator and the "
               'real engine — serving.mode="online" stays stage-level '
               "(the gateway's admission/SLO anchors are per-stage)")

        known = self.model.board_names()
        if kind == "board":
            _check(self.model.board in known, "model.board",
                   f"unknown board {self.model.board!r} — declare it under "
                   f"model.boards or use one of {list(known)}")
        if kind == "tenants":
            for t in self.workload.tenants:
                _check(t.board in known,
                       f"workload.tenants[{t.name}].board",
                       f"unknown board {t.board!r} — declare it under "
                       f"model.boards or use one of {list(known)}")
            _check(not self.model.tenant_weights
                   or len(self.model.tenant_weights)
                   == len(self.workload.tenants),
                   "model.tenant_weights",
                   f"got {len(self.model.tenant_weights)} weights for "
                   f"{len(self.workload.tenants)} tenants — one per tenant "
                   "(or empty to weight by tenant rates)")

    # ------------------------------------------------------------------ #
    def tenant_seed(self, index: int) -> int:
        t = self.workload.tenants[index]
        return t.seed if t.seed is not None else self.seed + index

    # ------------------------------------------------------------------ #
    def save(self, path: str):
        """Write the spec as stable, diffable JSON (sorted keys)."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "DeploymentSpec":
        try:
            with open(path) as f:
                d = json.load(f)
        except OSError as e:
            raise SpecError(
                f"cannot read spec file {path}: {e.strerror or e} — "
                "create one with serve --dump-config or "
                "DeploymentSpec.save") from None
        except json.JSONDecodeError as e:
            raise SpecError(f"{path} is not valid JSON: {e}") from None
        try:
            return cls.from_dict(d)
        except SpecError as e:
            raise SpecError(f"{path}: {e}") from None
