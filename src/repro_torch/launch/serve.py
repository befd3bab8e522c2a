"""Serving CLI of the PyTorch port: a thin flag -> DeploymentSpec adapter
over ``repro_torch.api``, with the flags of ``repro.launch.serve`` plus
``--device {cuda,cpu}`` (default ``cuda``: the real modes run their experts
on the card; ``cpu`` runs them on the host, as the tests do). Three modes
behind the SAME scheduler/manager code:

  --mode sim     paper-scale circuit-board workload (352 experts, 2500+ reqs)
                 on the event-driven engine.
  --mode real    actually loads PyTorch expert params across host/disk tiers
                 and runs their forwards on the device; ``--decode`` adds the
                 token-level decode loop on the decode_attention kernel.
  --mode online  streaming multi-tenant front-end (repro_torch.serve):
                 generator arrivals, per-tenant SLO telemetry, admission
                 control and autoscaling (``--engine real`` for real experts).

Config artifacts (--config, --dump-config, --dump-trace, --trace, --plan,
--save-plan) work as in the reference CLI.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode real --decode --requests 40
  PYTHONPATH=src python -m repro_torch.launch.serve --mode real --device cpu --requests 40
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.api import DeploymentSpec, Session, SpecError
from repro_torch.api.build import POLICIES
from repro_torch.api.spec import (DecodeSection, FleetSection, HeteroSection,
                                  MemorySection, ModelSpec, PolicySection,
                                  ServingSection, TenantSection,
                                  WorkloadSection)
from repro_torch.memory import POLICY_NAMES
from repro_torch.obs import log as obslog

log = obslog.get_logger("serve")


# --------------------------------------------------------------------------- #
# flags -> spec
# --------------------------------------------------------------------------- #

def _tenant_sections(args) -> tuple:
    """``--tenants A,B`` (or ``gold:A,batch:B``) + per-tenant rate/SLO/arrival
    lists (singletons broadcast)."""
    tokens = [t.strip() for t in args.tenants.split(",") if t.strip()]

    def broadcast(raw, cast):
        vals = [cast(v) for v in str(raw).split(",")]
        if len(vals) == 1:
            vals *= len(tokens)
        if len(vals) != len(tokens):
            raise SystemExit(f"expected 1 or {len(tokens)} values, got {raw!r}")
        return vals

    rates = broadcast(args.rates, float)
    slos = broadcast(args.slos, float)
    procs = broadcast(args.arrival, str)
    classes = broadcast(getattr(args, "request_class", "scan"), str)
    sections = []
    for i, tok in enumerate(tokens):
        name, _, board_key = tok.partition(":")
        sections.append(TenantSection(
            name=name, board=board_key or name, rate=rates[i],
            arrival=procs[i], request_class=classes[i],
            slo_seconds=slos[i]))
    return tuple(sections)


def spec_from_args(args) -> DeploymentSpec:
    """The CLI's entire flag surface as one DeploymentSpec (validation —
    including the old ad-hoc flag checks — happens in the spec)."""
    mode = getattr(args, "mode", "sim")
    engine = getattr(args, "engine", "sim")
    n_gpu, n_cpu = getattr(args, "executors", (3, 1))

    plan_path = getattr(args, "plan", None) or ""
    placement = getattr(args, "placement", "greedy")
    if plan_path and placement == "search":
        raise SystemExit("--plan applies a saved placement verbatim; it "
                         "cannot be combined with --placement search "
                         "(use --trace to reuse a saved traffic trace)")
    fleet = FleetSection(
        devices=getattr(args, "devices", 1), gpu_per_device=n_gpu,
        cpu=n_cpu, links=getattr(args, "links", "shared"),
        replication=getattr(args, "replication", 0),
        peer_bw_gbps=getattr(args, "peer_bw", 0.0),
        placement="plan" if plan_path else placement,
        trace_path=getattr(args, "trace", None) or "",
        plan_path=plan_path)
    memory = MemorySection(
        tier=getattr(args, "tier", "numa"),
        prefetch=getattr(args, "prefetch", None),
        prefetch_trigger=getattr(args, "prefetch_trigger", None))
    policy = PolicySection(name=args.policy,
                           evict=getattr(args, "evict", None))
    serving = ServingSection(
        mode=mode, engine=engine,
        admission=getattr(args, "admission", "none"),
        max_queue=getattr(args, "max_queue", 200),
        bucket_rate=getattr(args, "bucket_rate", None),
        bucket_burst=getattr(args, "bucket_burst", 50.0),
        autoscale=getattr(args, "autoscale", "auto"),
        slo_priority=not getattr(args, "no_slo_priority", False),
        tick=getattr(args, "tick", 0.5))

    tenants: tuple = ()
    if mode == "online" and engine == "sim":
        model = ModelSpec(kind="tenants")
        tenants = _tenant_sections(args)
    elif mode == "online":
        if any("," in str(v) for v in (args.rates, args.slos, args.arrival)):
            raise SystemExit(
                "--engine real serves a single tenant over the tiny local "
                "CoE: pass scalar --rates/--slos/--arrival (multi-tenant "
                "mixes need --engine sim); --tenants is ignored here")
        model = ModelSpec(kind="tiny")
        # the tiny CoE's source draws uniformly at random — "random" is
        # served as asked; "scan" has no board-scan analogue here and also
        # gets the uniform stream (the Session reports it as served)
        tenants = (TenantSection(
            name="local", board="A", rate=float(args.rates),
            arrival=args.arrival, request_class=args.request_class,
            slo_seconds=float(args.slos)),)
    elif mode == "real":
        model = ModelSpec(kind="tiny")
    else:
        model = ModelSpec(kind="board", board=getattr(args, "board", "A"))

    hetero = HeteroSection(
        host_exec=getattr(args, "host_exec", False),
        cpu_multiplier=getattr(args, "cpu_multiplier", 0.0),
        host_place=getattr(args, "host_place", False))
    decode = DecodeSection(
        enabled=getattr(args, "decode", False),
        tokens=getattr(args, "decode_tokens", 24),
        kv_evict=getattr(args, "kv_evict", "kv_aware"),
        kv_budget_fraction=getattr(args, "kv_budget", 0.5))
    return DeploymentSpec(
        model=model, fleet=fleet, memory=memory, policy=policy,
        serving=serving,
        workload=WorkloadSection(requests=args.requests, tenants=tenants),
        hetero=hetero, decode=decode, seed=getattr(args, "seed", 0))


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #

# dests that configure the run (with --config, any of them passed on the
# command line overrides just that field of the loaded spec; the artifact/io
# flags --out/--dump-config/--dump-trace/--save-plan always compose)
_CONFIG_DESTS = ("mode", "board", "tier", "policy", "evict", "prefetch",
                 "prefetch_trigger", "requests", "executors", "devices",
                 "links", "replication", "peer_bw", "placement", "trace",
                 "plan", "engine", "tenants", "arrival", "rates", "slos",
                 "request_class", "admission", "max_queue", "bucket_rate",
                 "bucket_burst", "autoscale", "no_slo_priority", "tick",
                 "host_exec", "cpu_multiplier", "host_place",
                 "decode", "decode_tokens", "kv_evict", "kv_budget", "seed")

# flag dest -> dotted spec path for the scalar overrides; the structural
# dests (executors, plan, no_slo_priority, the tenant-mix group) are mapped
# by hand in _resolve_spec
_DEST_PATHS = {
    "mode": "serving.mode", "engine": "serving.engine",
    "admission": "serving.admission", "max_queue": "serving.max_queue",
    "bucket_rate": "serving.bucket_rate",
    "bucket_burst": "serving.bucket_burst",
    "autoscale": "serving.autoscale", "tick": "serving.tick",
    "board": "model.board",
    "tier": "memory.tier", "prefetch": "memory.prefetch",
    "prefetch_trigger": "memory.prefetch_trigger",
    "policy": "policy.name", "evict": "policy.evict",
    "requests": "workload.requests",
    "devices": "fleet.devices", "links": "fleet.links",
    "replication": "fleet.replication", "peer_bw": "fleet.peer_bw_gbps",
    "placement": "fleet.placement", "trace": "fleet.trace_path",
    "host_exec": "hetero.host_exec",
    "cpu_multiplier": "hetero.cpu_multiplier",
    "host_place": "hetero.host_place",
    "decode": "decode.enabled", "decode_tokens": "decode.tokens",
    "kv_evict": "decode.kv_evict", "kv_budget": "decode.kv_budget_fraction",
    "seed": "seed",
}

# the tenant mix is one coherent group: overriding any of these rebuilds
# workload.tenants wholesale from the flag values (the flat comma-lists
# can't be partially merged into the file's structured tenant entries)
_TENANT_DESTS = ("tenants", "arrival", "rates", "slos", "request_class")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, metavar="SPEC_JSON",
                    help="run a saved DeploymentSpec; config flags passed "
                         "alongside override just those fields — flag > "
                         "file > default (docs/configuration.md)")
    ap.add_argument("--dump-config", default=None, metavar="PATH",
                    help="write the resolved DeploymentSpec JSON ('-' for "
                         "stdout) and exit without serving")
    ap.add_argument("--mode", default="sim", choices=["sim", "real", "online"])
    ap.add_argument("--board", default="A", choices=["A", "B"])
    ap.add_argument("--tier", default="numa", choices=["numa", "uma"])
    ap.add_argument("--policy", default="coserve", choices=list(POLICIES))
    ap.add_argument("--evict", default=None, choices=list(POLICY_NAMES),
                    help="override the policy's eviction order (e.g. "
                         "'observed' ranks victims by live per-expert load "
                         "with the dependency_prob order as cold-start "
                         "fallback); default: the policy's own setting")
    ap.add_argument("--prefetch", default=None,
                    choices=["off", "device", "all"],
                    help="override the policy's prefetch behaviour: off | "
                         "device (pool overlap only) | all (+ disk->host "
                         "promotion); default: the policy's own setting")
    ap.add_argument("--prefetch-trigger", default=None,
                    choices=["exec", "queue"],
                    help="when the cross-tier promotion fires: exec "
                         "(upstream starts executing, default) | queue "
                         "(upstream joins a queue — wider overlap window, "
                         "more speculative SSD traffic)")
    ap.add_argument("--requests", type=int, default=2500)
    ap.add_argument("--executors", type=lambda s: tuple(map(int, s.split(","))),
                    default=(3, 1), help="n_gpu,n_cpu (per device when "
                                         "--devices > 1)")
    ap.add_argument("--devices", type=int, default=1,
                    help="sim/online modes: number of accelerator devices, "
                         "each with its own pool behind the shared SSD")
    ap.add_argument("--links", default="shared",
                    choices=["shared", "per-device"],
                    help="host->device channel layout: one PCIe link the "
                         "whole fleet queues on, or one per accelerator")
    ap.add_argument("--replication", type=int, default=0,
                    help="planned device-pool copies of the hottest experts "
                         "beyond the primary (0 = paper placement)")
    ap.add_argument("--peer-bw", type=float, default=0.0,
                    help="device<->device (NVLink/ICI-class) peer fabric "
                         "bandwidth in GB/s; replicas of experts resident "
                         "on a sibling pool materialize pool->pool instead "
                         "of reloading from host DRAM (0 = no fabric)")
    ap.add_argument("--placement", default="greedy",
                    choices=["greedy", "search"],
                    help="initial expert placement: the greedy hot-first "
                         "sweep (paper §4.1) or the cost-model local search "
                         "over a workload trace (falls back to greedy when "
                         "nothing improves)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="--placement search: replay this saved "
                         "WorkloadTrace artifact (from --dump-trace) "
                         "instead of deriving a trace from the spec")
    ap.add_argument("--plan", default=None, metavar="PATH",
                    help="apply a saved PlacementPlan artifact verbatim "
                         "(from --save-plan) — yesterday's search, no "
                         "re-search")
    ap.add_argument("--dump-trace", default=None, metavar="PATH",
                    help="after the run, save the observed per-expert "
                         "traffic as a WorkloadTrace artifact")
    ap.add_argument("--save-plan", default=None, metavar="PATH",
                    help="save the placement plan this run served")
    ap.add_argument("--trace-events", default=None, metavar="PATH",
                    help="record a full flight-recorder trace and save it "
                         "as Chrome trace JSON (Perfetto-loadable; analyze "
                         "with tools/trace_report.py) — shorthand for "
                         "observability.trace='full' + trace_path")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress informational output (warnings/errors "
                         "and --dump-config '-' data still print)")
    ap.add_argument("--verbose", action="store_true",
                    help="debug-level progress output")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the real modes run their experts and the "
                         "decode kernel: the CUDA card (default; no card "
                         "is an error) or the host CPU")
    # --- online-mode flags (repro_torch.serve) ------------------------- #
    ap.add_argument("--engine", default="sim", choices=["sim", "real"],
                    help="online mode: event-driven sim or real experts")
    ap.add_argument("--tenants", default="A,B",
                    help="comma list of name[:board] tokens, boards A|B")
    ap.add_argument("--arrival", default="poisson",
                    help="arrival process per tenant (broadcasts): "
                         "poisson|bursty|diurnal|step")
    ap.add_argument("--rates", default="25",
                    help="mean req/s per tenant (broadcasts)")
    ap.add_argument("--slos", default="2.0",
                    help="end-to-end latency SLO seconds per tenant")
    ap.add_argument("--request-class", default="scan",
                    help="scan (board-scan locality) | random")
    ap.add_argument("--admission", default="none",
                    choices=["none", "queue_depth", "deadline", "token_bucket"])
    ap.add_argument("--max-queue", type=int, default=200)
    ap.add_argument("--bucket-rate", type=float, default=None,
                    help="token_bucket: admitted req/s per tenant "
                         "(default: the tenant mix's mean per-tenant rate)")
    ap.add_argument("--bucket-burst", type=float, default=50.0,
                    help="token_bucket: burst capacity in tokens")
    ap.add_argument("--autoscale", default="auto",
                    help="min,max executors; 'auto' = current fleet to 2x; "
                         "'none' disables scaling")
    ap.add_argument("--no-slo-priority", action="store_true",
                    help="disable deadline-EDF queue insertion")
    ap.add_argument("--tick", type=float, default=0.5,
                    help="telemetry/autoscaler control interval, sim seconds")
    # --- heterogeneous CPU co-execution -------------------------------- #
    ap.add_argument("--host-exec", action="store_true",
                    help="run host-DRAM-resident experts in place on the "
                         "CPU executors instead of stalling on a disk/PCIe "
                         "load; the scheduler prices min(execute_on_host, "
                         "load_then_execute_on_device) per arrival")
    ap.add_argument("--cpu-multiplier", type=float, default=0.0,
                    help="sim: derive the CPU service-time model as device "
                         "time x this factor (0 = the static measured CPU "
                         "constants; real mode measures the CPU line "
                         "directly)")
    ap.add_argument("--host-place", action="store_true",
                    help="--placement search: allow the search to plan "
                         "deliberate CPU residents (requires --host-exec)")
    # --- token-level decode (continuous batching + KV residency) -------- #
    ap.add_argument("--decode", action="store_true",
                    help="token-level decode: each request's terminal stage "
                         "becomes a prefill followed by a per-token decode "
                         "loop in a continuous batch, with paged KV blocks "
                         "resident in the executor's pool (sim and real "
                         "modes; online stays stage-level)")
    ap.add_argument("--decode-tokens", type=int, default=24,
                    help="decode length per request (the mean, for "
                         "decode.tokens_dist='geometric' specs)")
    ap.add_argument("--kv-evict", default="kv_aware",
                    choices=["kv_aware", "weight_only"],
                    help="under memory pressure: offload idle requests' KV "
                         "blocks to host DRAM (kv_aware) or keep KV pinned "
                         "and evict only expert weights (weight_only)")
    ap.add_argument("--kv-budget", type=float, default=0.5,
                    help="fraction of each device pool KV blocks may occupy "
                         "before offload/spill kicks in")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _deep_merge(base: dict, overlay: dict) -> dict:
    """Recursive dict merge, overlay wins; non-dict values replace."""
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _set_path(overlay: dict, dotted: str, value):
    node = overlay
    parts = dotted.split(".")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _resolve_spec(args, ap: argparse.ArgumentParser) -> DeploymentSpec:
    """Flags-only, file-only, or partial override: flag > file > default.

    With --config, every config flag whose value differs from its parser
    default is deep-merged over the loaded spec (a flag explicitly set to
    its default value is indistinguishable from unset — edit the file for
    that). The merged dict re-enters ``DeploymentSpec.from_dict``, so
    cross-field validation runs eagerly on the final configuration."""
    if not args.config:
        return spec_from_args(args)
    spec = DeploymentSpec.load(args.config)
    overridden = [d for d in _CONFIG_DESTS
                  if getattr(args, d) != ap.get_default(d)]
    if not overridden:
        return spec
    overlay: dict = {}
    for d in overridden:
        if d in _TENANT_DESTS:
            continue                      # handled as a group below
        if d == "executors":
            n_gpu, n_cpu = args.executors
            _set_path(overlay, "fleet.gpu_per_device", n_gpu)
            _set_path(overlay, "fleet.cpu", n_cpu)
        elif d == "plan":
            _set_path(overlay, "fleet.plan_path", args.plan)
            _set_path(overlay, "fleet.placement", "plan")
        elif d == "no_slo_priority":
            _set_path(overlay, "serving.slo_priority", False)
        else:
            _set_path(overlay, _DEST_PATHS[d], getattr(args, d))
    if any(d in _TENANT_DESTS for d in overridden):
        overlay.setdefault("workload", {})["tenants"] = [
            t.to_dict() for t in _tenant_sections(args)]
    merged = _deep_merge(spec.to_dict(), overlay)
    try:
        return DeploymentSpec.from_dict(merged)
    except SpecError as e:
        flags = ", ".join("--" + d.replace("_", "-") for d in overridden)
        raise SpecError(
            f"merging {flags} over {args.config}: {e}") from None


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        obslog.set_level(obslog.level_from_flags(args.quiet, args.verbose))
    except ValueError as e:
        raise SystemExit(str(e))
    try:
        spec = _resolve_spec(args, ap)
    except SpecError as e:
        raise SystemExit(str(e))
    if args.trace_events:
        # shorthand: record at "full" unless the spec already opted into a
        # level, and auto-export to the given path after the run
        obs = dataclasses.replace(
            spec.observability,
            trace=spec.observability.trace
            if spec.observability.trace != "off" else "full",
            trace_path=args.trace_events)
        spec = dataclasses.replace(spec, observability=obs)

    if args.dump_config:
        if args.dump_config == "-":
            print(json.dumps(spec.to_dict(), indent=2, sort_keys=True))
        else:
            spec.save(args.dump_config)
            log.info(f"wrote {args.dump_config}")
        return spec.to_dict()

    log.debug(f"mode={spec.serving.mode} engine={spec.serving.engine} "
              f"policy={spec.policy.name} requests={spec.workload.requests}")
    try:
        sess = Session(spec, device=args.device)
    except (SpecError, ValueError) as e:
        raise SystemExit(str(e))
    result = sess.run()
    if args.dump_trace:
        sess.save_trace(args.dump_trace)
    if args.save_plan:
        sess.save_plan(args.save_plan)
    if args.trace_events:
        log.debug(f"wrote flight-recorder trace {args.trace_events}")
    log.info(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
