"""LM Collaboration-of-Experts (the paper's §2.1 Qihoo-360 scenario) on the
card: a domain router dispatches prompts to specialised LM experts —
StarCoder2-3B-shaped transformer stacks, Falcon-Mamba-7B-shaped SSM stacks
or Moonlight-16B-A3B-shaped MoE stacks, with seeded random weights —
served through CoServe with real
disk -> host -> device loads. The twin of the JAX package's
``examples/lm_coe_router.py``: the same six domain experts plus a shared
safety expert that depends on all six and checks every draft, the same
routing, chain probabilities, payload hooks, profiling and policies; only
the experts' config is chosen by ``--arch``.

Each expert's forward runs with ``attn_impl="pallas"``, so on the card its
attention goes through the hand-written ``flash_attention`` kernel
(StarCoder2-3B, Moonlight-16B-A3B) or its selective scan through
``mamba_scan`` (Falcon-Mamba-7B); Moonlight's MoE layers route each token
to 6 of 64 experts (``models/moe.py``).

  python -m repro_torch.launch.lm_coe_router                     # smoke width, on the card
  python -m repro_torch.launch.lm_coe_router --width full --layers 2
  python -m repro_torch.launch.lm_coe_router --arch falcon_mamba_7b --width full --layers 2
  python -m repro_torch.launch.lm_coe_router --arch moonshot_v1_16b_a3b --width full --layers 2
  python -m repro_torch.launch.lm_coe_router --device cpu        # on the host

``--width full`` is the published width: StarCoder2-3B's d_model 3072,
24/2 heads of 128, d_ff 12288, vocab 49152; Falcon-Mamba-7B's d_model 4096,
d_inner 8192, state 16, dt_rank 256, vocab 65024; Moonlight-16B-A3B's
d_model 2048, 16 heads of 128, 64 experts of width 1408 (top-6), vocab
163840; the last two with their weights in bfloat16 (below). ``--layers``
cuts the depth, and a report of the run names that cut.

With capacity routing (Moonlight's capacity factor 1.25) a served token
can depend on the other prompts in its padded batch: above 64 tokens a
group (a batch of 8 prompts of 16 tokens) an expert takes at most its
capacity of choices and drops the rest, as the reference's GShard-style
layer does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import flatten_params, nest_params
from repro_torch.core import (COSERVE, SAMBA_PARALLEL, CoEModel,
                              CoServeSystem, DeviceProfile, ExecutorSpec,
                              ExpertSpec, Request, RoutingModule, TierSpec,
                              microbenchmark_arch, run_real)
from repro_torch.core.engines import (HostStore, RealEngine, resolve_device,
                                      synchronize)
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.obs import Tracer

ARCHS = ("starcoder2_3b", "falcon_mamba_7b", "moonshot_v1_16b_a3b")
# full width keeps these experts' weights in bfloat16, the dtype they
# compute in
BF16_WEIGHTS = ("falcon_mamba_7b", "moonshot_v1_16b_a3b")
DOMAINS = ["code", "math", "law", "chat", "bio", "finance"]
N_REQS = 90
PROMPT_TOKENS = 16
SAFETY_SEED, SAMPLE_SEED = 99, 7      # domain i's expert is drawn from seed i

PAYLOAD = {
    "make_batch": lambda reqs: np.stack([r.data["tokens"] for r in reqs]),
    "interpret": lambda out: ["ok" if int(t) % 7 else "flag" for t in out],
}


def lm_config(width: str = "smoke", layers: int = 0,
              arch: str = "starcoder2_3b") -> ModelConfig:
    """The experts' config: ``arch`` at its smoke width (as the example
    serves it) or its published width, with ``layers`` > 0 cutting the
    depth.

    Falcon-Mamba-7B and Moonlight-16B-A3B at full width keep their weights
    in bfloat16, the dtype they compute in, so that every forward skips a
    cast of its weights and the seven experts take half the host memory
    (four of them are written to the disk tier as well): at 2 layers a
    Falcon-Mamba expert has 476.9 M parameters, 6.7 GB for seven in
    bfloat16 instead of 13.4 GB; a Moonlight expert 1.81 B, 25.4 GB for
    seven instead of 50.7 GB."""
    if arch not in ARCHS:
        raise ValueError(f"arch must be one of {ARCHS}, got {arch!r}")
    cfg = get_config(arch)
    if width == "smoke":
        cfg = smoke_config(cfg)
    elif width != "full":
        raise ValueError(f"width must be 'smoke' or 'full', got {width!r}")
    elif arch in BF16_WEIGHTS:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, remat=False, attn_impl="pallas")
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg


def make_lm_apply(cfg: ModelConfig):
    """The expert forward: next-token argmax of each prompt's last position.
    ``lm_apply.calls`` counts the forwards it ran."""
    def lm_apply(params, tokens):
        logits, _ = transformer.forward(nest_params(params), tokens, cfg,
                                        mode="eval")
        lm_apply.calls += 1
        return torch.argmax(logits[:, -1], -1)

    lm_apply.calls = 0
    return lm_apply


def expert_params(cfg: ModelConfig, seed: int, device) -> Dict[str, torch.Tensor]:
    """One expert's flat weights drawn from ``seed`` on ``device``, handed
    back on the host (where the store keeps them)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {k: v.cpu() for k, v in
            flatten_params(transformer.init_params(gen, cfg)).items()}


def expert_ids() -> List[str]:
    return [f"lm_{d}" for d in DOMAINS] + ["lm_safety"]


def build_lm_system(cfg: ModelConfig, policy=COSERVE, *, device="cuda",
                    params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                    store: Optional[HostStore] = None,
                    tracer: Optional[Tracer] = None):
    """The LM CoE served under ``policy`` on ``device``: (system, coe),
    recording into ``tracer`` where given.

    ``params`` (expert id -> flat tensor dict, e.g. converted from the JAX
    package's) replaces the seeded weights of the experts it names.
    ``store``, a HostStore an earlier call filled, is served from as it
    stands (the example's two policies share one store); without it a new
    store is filled, odd domains and the safety expert on the disk tier."""
    dev = resolve_device(device)
    params = params or {}
    if store is None:
        store = HostStore(root=tempfile.mkdtemp(prefix="coserve_lm_"),
                          pin_memory=dev.type == "cuda")
        seeds = dict(zip(expert_ids(), [*range(len(DOMAINS)), SAFETY_SEED]))
        for i, eid in enumerate(expert_ids()):
            p = params.get(eid) or expert_params(cfg, seeds[eid], dev)
            on_disk = eid == "lm_safety" or i % 2
            (store.put_disk if on_disk else store.put_host)(eid, p)
    mem = sum(t.numel() * t.element_size()
              for t in store.fetch("lm_code")[0].values())

    experts = [ExpertSpec(id=f"lm_{d}", arch="tiny_lm", mem_bytes=mem,
                          payload=PAYLOAD, usage_prob=1.0 / len(DOMAINS))
               for d in DOMAINS]
    experts.append(ExpertSpec(
        id="lm_safety", arch="tiny_lm", mem_bytes=mem, payload=PAYLOAD,
        depends_on=tuple(f"lm_{d}" for d in DOMAINS), usage_prob=0.9))
    routing = RoutingModule(
        first_expert_fn=lambda data: f"lm_{data['domain']}",
        next_expert_fn=lambda req, eid, out: (
            "lm_safety" if eid != "lm_safety" else None),
        chain_prob={f"lm_{d}": {"lm_safety": 1.0} for d in DOMAINS})
    coe = CoEModel(experts, routing)
    lm_apply = make_lm_apply(cfg)

    # offline profiling (paper §4.5) with the real runner; the clock is
    # read after the device finished the batch
    sample = {k: v.to(dev) for k, v in
              expert_params(cfg, SAMPLE_SEED, dev).items()}

    def run_batch(n):
        x = torch.zeros((n, PROMPT_TOKENS), dtype=torch.int32, device=dev)
        with torch.no_grad():
            lm_apply(sample, x)
            synchronize(dev)
            t0 = time.perf_counter()
            lm_apply(sample, x)
            synchronize(dev)
        return time.perf_counter() - t0

    tier = TierSpec(name="lm", unified=True, host_cache_bytes=0,
                    device_bytes=4 * mem)
    prof = microbenchmark_arch("tiny_lm", run_batch, mem,
                               PROMPT_TOKENS * 4, tier,
                               batch_sizes=(1, 2, 4, 8), repeats=2)
    del sample
    dev_prof = DeviceProfile("gpu", tier, {"tiny_lm": prof})
    system = CoServeSystem(
        coe, [ExecutorSpec("gpu", dev_prof, 2 * mem, "gpu")] * 2,
        {"gpu": 3 * mem},                      # pool: 3 of 7 LM experts fit
        policy=policy, tier=tier, tracer=tracer,
        engine=RealEngine(coe, store, {"tiny_lm": lm_apply}, device=dev))
    return system, coe


def make_requests(rng: np.random.RandomState, cfg: ModelConfig,
                  n: int = N_REQS) -> List[Request]:
    """``n`` prompts of random tokens, each to a random domain, drawn from
    ``rng`` in the example's order."""
    out = []
    for i in range(n):
        dom = DOMAINS[rng.randint(len(DOMAINS))]
        out.append(Request(
            id=i, expert_id=f"lm_{dom}",
            data={"domain": dom,
                  "tokens": rng.randint(0, cfg.vocab_size,
                                        PROMPT_TOKENS).astype(np.int32)}))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHS, default="starcoder2_3b")
    ap.add_argument("--width", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (0: the config's own)")
    ap.add_argument("--requests", type=int, default=N_REQS)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    cfg = lm_config(args.width, args.layers, args.arch)
    rng = np.random.RandomState(0)
    report = {"arch": args.arch, "width": args.width,
              "layers": cfg.num_layers, "layers_cut": bool(args.layers),
              "policies": []}
    store = None
    try:
        for policy in (COSERVE, SAMBA_PARALLEL):
            system, _ = build_lm_system(cfg, policy, device=args.device,
                                        store=store)
            store = system.engine.store
            m = run_real(system, make_requests(rng, cfg, args.requests))
            line = {"policy": policy.name, "completed": m.completed,
                    "expert_loads": m.switches, "makespan_s": m.makespan}
            report["policies"].append(line)
            print(json.dumps(line), flush=True)
    finally:
        if store is not None:
            shutil.rmtree(store.root, ignore_errors=True)
    return report


if __name__ == "__main__":
    main()
