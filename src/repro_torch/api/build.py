"""build_system: one DeploymentSpec in, one wired CoServeSystem out.

The port's twin of ``repro.api.build``: the same wiring from a declarative
spec to running objects — tier resolution, catalog construction, fleet
layout, policy overrides, placement (greedy sweep, cost-model search, or a
saved plan artifact) — with the real system's experts as PyTorch MLPs on a
CUDA device (or the CPU when the caller asks for it). The board and tenant
kinds build the simulated system exactly as the reference does.
"""
from __future__ import annotations

import dataclasses
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.artifacts import load_plan, load_trace
from repro_torch.api.spec import DeploymentSpec, SpecError
from repro_torch.core.coe import CoEModel, ExpertSpec, Request, RoutingModule
from repro_torch.core.decode import DecodeConfig
from repro_torch.core.profiler import DeviceProfile, microbenchmark_arch
from repro_torch.core.serving import (COSERVE, COSERVE_NONE, SAMBA,
                                      SAMBA_FIFO, SAMBA_PARALLEL,
                                      CoServeSystem, ExecutorSpec,
                                      SystemPolicy)
from repro_torch.core.workload import (BOARD_A, BOARD_B, BoardSpec,
                                       build_board_coe, make_executor_specs,
                                       make_task_requests)
from repro_torch.fleet import (FleetSpec, PlacementPlan, SearchConfig,
                               build_fleet, search_placement,
                               trace_from_requests, trace_from_usage,
                               validate_pool_groups)
from repro_torch.memory import NUMA, TPU_V5E, UMA, TierSpec
from repro_torch.obs import NULL_TRACER, Tracer

POLICIES: Dict[str, SystemPolicy] = {
    "coserve": COSERVE,
    "coserve_none": COSERVE_NONE,
    "samba": SAMBA,
    "samba_fifo": SAMBA_FIFO,
    "samba_parallel": SAMBA_PARALLEL,
}

_TIER_PRESETS = {"numa": NUMA, "uma": UMA, "tpu_v5e": TPU_V5E}

_TIER_OVERRIDES = ("disk_bw", "host_to_device_bw", "host_overhead",
                   "disk_overhead", "host_cache_bytes", "device_bytes",
                   "unified")


# --------------------------------------------------------------------------- #
# resolution: spec sections -> concrete objects
# --------------------------------------------------------------------------- #

def resolve_tier(spec: DeploymentSpec) -> TierSpec:
    """The run's TierSpec: the named preset, any explicit memory-section
    overrides, plus the peer (NVLink/ICI-class) fabric from
    ``fleet.peer_bw_gbps``."""
    tier = _TIER_PRESETS[spec.memory.tier]
    changes = {f: getattr(spec.memory, f) for f in _TIER_OVERRIDES
               if getattr(spec.memory, f) is not None}
    if spec.memory.name:
        changes["name"] = spec.memory.name
    if changes:
        tier = dataclasses.replace(tier, **changes)
    if spec.fleet.peer_bw_gbps:
        tier = dataclasses.replace(tier, peer_bw=spec.fleet.peer_bw_gbps * 1e9)
    return tier


def resolve_policy(spec: DeploymentSpec) -> SystemPolicy:
    """Named preset + the memory-section prefetch overrides + the eviction
    override (``off``/``device``/``all`` semantics match the old
    ``--prefetch`` flag exactly)."""
    policy = POLICIES[spec.policy.name]
    mode = spec.memory.prefetch
    if mode == "off":
        policy = dataclasses.replace(policy, prefetch=False,
                                     host_prefetch=False)
    elif mode == "device":
        policy = dataclasses.replace(policy, host_prefetch=False)
    elif mode == "all":
        policy = dataclasses.replace(policy, prefetch=True,
                                     host_prefetch=True)
    if spec.memory.prefetch_trigger is not None:
        policy = dataclasses.replace(
            policy, prefetch_trigger=spec.memory.prefetch_trigger)
    if spec.policy.evict is not None:
        policy = dataclasses.replace(policy, evict=spec.policy.evict)
    if spec.hetero.host_exec:
        policy = dataclasses.replace(policy, host_exec=True)
    return policy


def resolve_decode(spec: DeploymentSpec) -> Optional[DecodeConfig]:
    """The run's DecodeConfig, or None for stage-level serving. The token
    sampler is seeded from the spec seed so decode-on runs replay exactly."""
    d = spec.decode
    if not d.enabled:
        return None
    return DecodeConfig(tokens=d.tokens, tokens_dist=d.tokens_dist,
                        block_tokens=d.block_tokens,
                        token_bytes=d.token_bytes,
                        kv_budget_fraction=d.kv_budget_fraction,
                        kv_evict=d.kv_evict,
                        max_decode_batch=d.max_decode_batch,
                        step_k=d.step_k, step_b=d.step_b, seed=spec.seed)


def board_specs(spec: DeploymentSpec) -> Dict[str, BoardSpec]:
    """Every board the spec may reference: customs + the A/B presets."""
    boards = {b.name: BoardSpec(**b.to_dict()) for b in spec.model.boards}
    boards.setdefault("A", BOARD_A)
    boards.setdefault("B", BOARD_B)
    return boards


def make_tenants(spec: DeploymentSpec):
    """``repro_torch.serve.TenantSpec`` objects for the workload's tenant mix,
    with per-tenant seeds derived from the spec seed unless pinned."""
    from repro_torch.serve import TenantSpec

    boards = board_specs(spec)
    return [TenantSpec(name=t.name, board=boards[t.board], rate=t.rate,
                       process=t.arrival, request_class=t.request_class,
                       slo_seconds=t.slo_seconds, seed=spec.tenant_seed(i))
            for i, t in enumerate(spec.workload.tenants)]


def build_catalog(spec: DeploymentSpec) -> CoEModel:
    """The expert catalog (sim engines): one board, or the usage-weighted
    union of the tenant boards. ``kind="tiny"`` catalogs are built together
    with their real engine in ``build_real_system``."""
    if spec.model.kind == "board":
        return build_board_coe(board_specs(spec)[spec.model.board])
    if spec.model.kind == "tenants":
        from repro_torch.serve.arrivals import merge_board_coe

        boards = board_specs(spec)
        weights = list(spec.model.tenant_weights) \
            or [t.rate for t in spec.workload.tenants]
        return merge_board_coe([boards[t.board]
                                for t in spec.workload.tenants], weights)
    raise SpecError('model.kind="tiny" catalogs are built by '
                    "build_real_system (they need a real engine)")


def build_layout(spec: DeploymentSpec, tier: TierSpec
                 ) -> Tuple[Dict[str, int], List[ExecutorSpec]]:
    """(pools, executor specs) for the spec's fleet shape. Single-assign
    policies (the Samba baselines) normalize to one executor on one device,
    exactly like the old CLI: building a fleet for a baseline that only ever
    uses executors[0] would distort the comparison."""
    n_gpu, n_cpu = spec.fleet.gpu_per_device, spec.fleet.cpu
    devices = spec.fleet.devices
    if POLICIES[spec.policy.name].assign == "single":
        n_gpu, n_cpu, devices = 1, 0, 1
    mult = spec.hetero.cpu_multiplier
    if devices > 1:
        fleet = FleetSpec(n_devices=devices, gpu_per_device=n_gpu,
                          n_cpu=n_cpu, links=spec.fleet.links)
        return build_fleet(tier, fleet, cpu_multiplier=mult)
    return make_executor_specs(tier, n_gpu, n_cpu, cpu_multiplier=mult)


def make_requests(spec: DeploymentSpec) -> List[Request]:
    """The materialized offline workload (sim mode): the paper task stream
    for one board, or ``workload.requests`` arrivals of the tenant mix."""
    if spec.model.kind == "board":
        return make_task_requests(board_specs(spec)[spec.model.board],
                                  spec.workload.requests,
                                  interval=spec.workload.interval_s)
    from repro_torch.serve import multi_tenant_stream

    return list(multi_tenant_stream(make_tenants(spec),
                                    spec.workload.requests))


# --------------------------------------------------------------------------- #
# placement
# --------------------------------------------------------------------------- #

def _resolve_placement(spec: DeploymentSpec, coe: CoEModel, pools, specs,
                       tier: TierSpec,
                       requests: Optional[List[Request]]
                       ) -> Tuple[Optional[PlacementPlan], Optional[dict]]:
    """(plan, search report). ``greedy`` defers to CoServeSystem's own
    sweep; ``search`` seeds with the greedy sweep and searches under the
    spec's replication budget over a trace (saved artifact > materialized
    requests > static P(use)); ``plan`` applies a saved artifact verbatim —
    yesterday's search, no re-search."""
    fleet = spec.fleet
    if fleet.placement == "plan":
        return load_plan(fleet.plan_path, coe, capacities=pools), None
    if fleet.placement != "search":
        return None, None
    if fleet.trace_path:
        trace = load_trace(fleet.trace_path)
    elif requests is not None:
        trace = trace_from_requests(coe, requests[:512])
    else:
        # online path: no requests exist yet — search over the expected load
        # (pre-assessed P(use), already weighted by tenant rates)
        trace = trace_from_usage(coe, length=512)
    greedy = PlacementPlan.build(coe, pools, replication=fleet.replication)
    config = SearchConfig(seed=spec.seed, replication=fleet.replication)
    if spec.hetero.host_place:
        # the CPU arm's service-time penalty comes from the profiled CPU
        # service-time model, not a hand-picked constant
        config = dataclasses.replace(
            config, host_place=True, host_exec_factor=_host_exec_factor(specs))
    res = search_placement(
        coe, pools, trace, tier, links=fleet.links,
        pool_devices=validate_pool_groups(specs), seed_plan=greedy,
        config=config)
    return res.plan, res.snapshot()


def _host_exec_factor(specs) -> float:
    """CPU service time as a multiple of device time, read off the profiled
    ``ArchProfile.cpu_k`` line of the first accelerator spec (falls back to
    the SearchConfig default when no CPU profile was taken)."""
    for s in specs:
        if s.device in ("host", "cpu"):
            continue
        profs = s.profile.arch_profiles
        prof = profs.get("resnet101") or next(iter(profs.values()), None)
        if prof is not None and prof.k > 0 and prof.cpu_k > 0:
            return prof.cpu_k / prof.k
    return SearchConfig().host_exec_factor


# --------------------------------------------------------------------------- #
# the real tiny system: PyTorch MLP experts on the device
# --------------------------------------------------------------------------- #

def _tiny_apply_fns():
    def mlp(params, x):
        h = torch.tanh(x @ params["w1"] + params["b1"])
        return h @ params["w2"] + params["b2"]

    return {"tiny_cls": mlp, "tiny_det": mlp}


def _tiny_params(gen: torch.Generator, d_in: int, d_h: int, d_out: int):
    return {"w1": torch.randn((d_in, d_h), generator=gen) * 0.1,
            "b1": torch.zeros((d_h,), dtype=torch.float32),
            "w2": torch.randn((d_h, d_out), generator=gen) * 0.1,
            "b2": torch.zeros((d_out,), dtype=torch.float32)}


def real_board_layout(n_components: int, n_detection: int):
    """Deterministic component->detection wiring of the tiny real CoE.
    One seeded stream, drawn in this exact order — request generators must
    use this helper (not fresh RandomState(0) draws) to match the catalog's
    declared dependencies."""
    rng = np.random.RandomState(0)
    det_assign = rng.randint(0, n_detection, n_components)
    needs_det = rng.rand(n_components) < 0.5
    return needs_det, det_assign


def build_real_system(n_components: int = 24, n_detection: int = 4,
                      pool_experts: int = 6, n_executors: int = 2,
                      store_root: Optional[str] = None,
                      policy: SystemPolicy = COSERVE,
                      d_hidden: int = 256,
                      tracer: Optional[Tracer] = None,
                      decode: Optional[DecodeConfig] = None,
                      device="cuda",
                      params: Optional[Dict[str, Dict[str, torch.Tensor]]]
                      = None,
                      ) -> Tuple[CoServeSystem, CoEModel]:
    """A small CoE of real PyTorch MLP experts over host+disk tiers, served
    on ``device``. ``params`` (expert id -> flat tensor dict, e.g. from
    ``repro_torch.convert.params_from_reference``) replaces the seeded
    initial weights of the experts it names."""
    from repro_torch.core.engines import (HostStore, RealEngine,
                                          resolve_device, synchronize)

    dev = resolve_device(device)
    params = params or {}
    apply_fns = _tiny_apply_fns()
    store = HostStore(root=store_root or tempfile.mkdtemp(prefix="coserve_"),
                      pin_memory=dev.type == "cuda")
    needs_det, det_assign = real_board_layout(n_components, n_detection)

    payload = {
        "make_batch": lambda reqs: np.stack([r.data["x"] for r in reqs]),
        "interpret": lambda out: ["ok" if o == 0 else "defect"
                                  for o in np.argmax(out, -1)],
    }
    experts: List[ExpertSpec] = []
    gen = torch.Generator().manual_seed(0)
    mem = (64 * d_hidden + d_hidden * 2 + d_hidden + 2) * 4
    for c in range(n_components):
        eid = f"cls{c:03d}"
        seeded = _tiny_params(gen, 64, d_hidden, 2)
        # half the catalog starts on the disk tier, half in host DRAM
        (store.put_disk if c % 2 else store.put_host)(
            eid, params.get(eid, seeded))
        experts.append(ExpertSpec(
            id=eid, arch="tiny_cls", mem_bytes=mem, payload=payload,
            usage_prob=1.0 / n_components))
    for dnum in range(n_detection):
        eid = f"det{dnum:02d}"
        seeded = _tiny_params(gen, 64, d_hidden, 2)
        store.put_disk(eid, params.get(eid, seeded))
        ups = tuple(f"cls{c:03d}" for c in range(n_components)
                    if needs_det[c] and det_assign[c] == dnum)
        experts.append(ExpertSpec(
            id=eid, arch="tiny_det", mem_bytes=mem, payload=payload,
            depends_on=ups, usage_prob=0.2))

    def first_expert(data) -> str:
        return f"cls{data['component']:03d}"

    def next_expert(req: Request, eid: str, output) -> Optional[str]:
        if eid.startswith("cls") and req.data.get("needs_detection") \
                and output == "ok":
            return f"det{req.data['det_expert']:02d}"
        return None

    coe = CoEModel(experts, RoutingModule(first_expert, next_expert))
    engine = RealEngine(coe, store, apply_fns, device=dev)

    # offline profiling with the real runner (paper §4.5): the clock is read
    # after the device finished the batch
    def runner(on: torch.device, sample):
        def run_batch(n: int) -> float:
            x = torch.zeros((n, 64), dtype=torch.float32, device=on)
            fn = apply_fns["tiny_cls"]
            with torch.no_grad():
                fn(sample, x)  # warm
                synchronize(on)
                t0 = time.perf_counter()
                fn(sample, x)
                synchronize(on)
            return time.perf_counter() - t0
        return run_batch

    tier = TierSpec(name="local", unified=True, host_cache_bytes=0,
                    device_bytes=pool_experts * mem + 4 * mem)
    sample = _tiny_params(torch.Generator().manual_seed(9), 64, d_hidden, 2)
    dev_sample = {n: t.to(dev) for n, t in sample.items()}

    # CPU service-time line, measured with the same runner on the host
    # (paper §4.1's heterogeneous serving premise)
    cpu = torch.device("cpu")
    prof = microbenchmark_arch("tiny_cls", runner(dev, dev_sample), mem,
                               act_bytes_per_item=64 * 4, tier=tier,
                               batch_sizes=(1, 2, 4, 8), repeats=2,
                               run_batch_cpu=runner(cpu, sample))
    det_prof = dataclasses.replace(prof, arch="tiny_det")
    dev_prof = DeviceProfile(device="gpu", tier=tier,
                             arch_profiles={"tiny_cls": prof,
                                            "tiny_det": det_prof})
    pools = {"gpu": pool_experts * mem}
    specs = [ExecutorSpec("gpu", dev_prof, 4 * mem, "gpu")
             for _ in range(n_executors)]
    system = CoServeSystem(coe, specs, pools, policy=policy, tier=tier,
                           engine=engine, tracer=tracer, decode=decode)
    return system, coe


# --------------------------------------------------------------------------- #
# the public entry point
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class BuildContext:
    """Everything ``build_system`` wired up, for callers (the Session) that
    need more than the system object itself."""
    spec: DeploymentSpec
    system: CoServeSystem
    coe: CoEModel
    tier: Optional[TierSpec]
    requests: Optional[List[Request]]       # sim mode: materialized workload
    search_report: Optional[dict]           # placement == "search"
    tenants: list                           # online modes: TenantSpec list
    executor_specs: Optional[List[ExecutorSpec]] = None  # layout (sim path)
    tracer: Tracer = NULL_TRACER            # flight recorder (observability)


def build_context(spec: DeploymentSpec,
                  placement: Optional[PlacementPlan] = None,
                  device="cuda") -> BuildContext:
    """Wire a full system (plus the run context) from a spec. ``placement``
    overrides the spec's placement section with an explicit plan object —
    the hook benchmark suites use to score externally-searched plans.
    ``device`` is where a ``model.kind="tiny"`` system's experts run; the
    simulated kinds never touch it."""
    mode, engine = spec.serving.mode, spec.serving.engine
    policy = resolve_policy(spec)
    obs = spec.observability
    tracer = NULL_TRACER if obs.trace == "off" \
        else Tracer(level=obs.trace, capacity=obs.buffer_events)

    if spec.model.kind == "tiny":
        m = spec.model
        system, coe = build_real_system(
            n_components=m.tiny_components, n_detection=m.tiny_detection,
            pool_experts=m.tiny_pool_experts, n_executors=m.tiny_executors,
            d_hidden=m.tiny_d_hidden, policy=policy, tracer=tracer,
            decode=resolve_decode(spec), device=device)
        if obs.sanitize:
            from repro_torch.analysis.cachesan import CacheSanitizer
            CacheSanitizer().install(system)
        tenants = make_tenants(spec) if mode == "online" else []
        return BuildContext(spec=spec, system=system, coe=coe, tier=None,
                            requests=None, search_report=None,
                            tenants=tenants, tracer=tracer)

    tier = resolve_tier(spec)
    coe = build_catalog(spec)
    pools, specs = build_layout(spec, tier)
    requests = make_requests(spec) if mode == "sim" else None
    search_report = None
    if placement is None:
        placement, search_report = _resolve_placement(
            spec, coe, pools, specs, tier, requests)
    system = CoServeSystem(coe, specs, pools, policy=policy, tier=tier,
                           links=spec.fleet.links,
                           replication=spec.fleet.replication,
                           placement=placement, tracer=tracer,
                           decode=resolve_decode(spec))
    if obs.sanitize:
        from repro_torch.analysis.cachesan import CacheSanitizer
        CacheSanitizer().install(system)
    tenants = make_tenants(spec) if spec.workload.tenants else []
    return BuildContext(spec=spec, system=system, coe=coe, tier=tier,
                        requests=requests, search_report=search_report,
                        tenants=tenants, executor_specs=specs,
                        tracer=tracer)


def build_system(spec: DeploymentSpec,
                 placement: Optional[PlacementPlan] = None,
                 device="cuda") -> CoServeSystem:
    """One spec in, one wired ``CoServeSystem`` out."""
    return build_context(spec, placement=placement, device=device).system
