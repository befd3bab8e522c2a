"""One cell: the program's CoE system built from its public classes, a warm
round, then the measured window of closed-loop rounds.

The system is the LM Collaboration-of-Experts of the paper's §2.1 as
``repro_torch.launch.lm_coe_router.build_lm_system`` builds it, at the
configuration's count of domains: domain experts and a safety expert that
depends on all of them; each request goes to its domain's expert, then to
the safety expert; two executors, each with ``batch_bytes`` for
activations, share one device pool that holds ``pool_experts`` experts,
fewer than the host store holds; the offline profile is
taken by ``microbenchmark_arch`` at the mix's prompt length. It is built
here so that the benchmark makes the weights, reads each prompt's
last-position logits, and reads the wall clock at each completion.

Every round passes through one ``Simulation``: its virtual clock runs on
from round to round (a round's requests arrive at the clock where the last
one ended), so the executors' busy times, the channels' and the pool's
residency carry over as in one long run.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List

import numpy as np
import torch

from coebench import reference, traffic, weights

ARCH = "lm"
SAFETY = "lm_safety"


def port_config(cfg: dict):
    """The program's ModelConfig of a configuration file: its ``port.base``
    config with ``port.overrides``, every published key of ``port.matches``
    held equal to the program's attribute."""
    from repro_torch.configs import get_config

    port = cfg["port"]
    pc = dataclasses.replace(get_config(port["base"]), **port["overrides"])
    for key, attr in port["matches"].items():
        if getattr(pc, attr) != cfg[key]:
            raise ValueError(f"{cfg['name']}: the program's {attr} "
                             f"{getattr(pc, attr)!r} is not the file's "
                             f"{key} {cfg[key]!r}")
    return pc


def expert_ids(cfg: dict) -> List[str]:
    return [f"lm_{d}" for d in cfg["coe"]["domains"]] + [SAFETY]


def expected_chain(domain: str) -> List[str]:
    return [f"lm_{domain}", SAFETY]


class Spans:
    """Host-clock spans (``time.time_ns``, the profiler's time base) that
    the benchmark records around its calls into the program in a traced
    window, by name."""

    def __init__(self):
        self.by_name: Dict[str, List[tuple]] = {}

    @contextmanager
    def __call__(self, on: bool, name: str):
        if not on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.by_name.setdefault(name, []).append((t0, time.time_ns()))

    def wrap(self, obj, attr: str, name: str) -> None:
        inner = getattr(obj, attr)

        def call(*a, **kw):
            with self(True, name):
                return inner(*a, **kw)

        setattr(obj, attr, call)


class Recorder:
    """What the benchmark's hooks see of the served path: each stage a
    request ran on, the logits of the requests marked for the comparison,
    and (in the window) each forward's shape and, in a traced run, its time
    between two device synchronisations."""

    def __init__(self, device: torch.device, traced: bool):
        self.device = device
        self.traced = traced
        self.window = False
        self.batch = None                      # (expert, requests)
        self.stages: Dict[int, List[str]] = {}
        self.samples: List[dict] = []
        self.forwards: List[tuple] = []        # (rows padded, rows, seq)
        self.forward_s = 0.0
        self.done: Dict[int, float] = {}
        self.spans = Spans()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def root(req) -> int:
        return req.parent_id if req.parent_id is not None else req.id

    def payload(self, expert: str) -> dict:
        def make_batch(reqs):
            self.batch = (expert, reqs)
            return np.stack([r.data["tokens"] for r in reqs])

        def interpret(out):
            served = out.argmax(-1)
            _, reqs = self.batch
            if self.window:
                for r, row, tok in zip(reqs, out, served):
                    root = self.root(r)
                    stages = self.stages.setdefault(root, [])
                    stages.append(expert)
                    if r.data["check"]:
                        self.samples.append({
                            "root": root, "expert": expert,
                            "stage": len(stages) - 1,
                            "domain": r.data["domain"],
                            "tokens": r.data["tokens"],
                            "logits": np.array(row, np.float32)})
            return [int(t) for t in served]

        return {"make_batch": make_batch, "interpret": interpret}

    def apply_fn(self, port_cfg):
        from repro_torch.convert import nest_params
        from repro_torch.models import transformer

        def apply(params, x):
            timed = self.traced and self.window
            if timed:
                self.sync()
                t0 = time.perf_counter()
            with self.spans(timed, "forward"):
                logits, _ = transformer.forward(nest_params(params), x,
                                                port_cfg, mode="eval")
                last = logits[:, -1].float()
            if timed:
                self.sync()
                self.forward_s += time.perf_counter() - t0
            if self.window and self.batch is not None:
                self.forwards.append((x.shape[0], len(self.batch[1]),
                                      x.shape[1]))
            return last

        return apply


@dataclasses.dataclass
class Setup:
    cfg: dict
    mix: dict
    seed: int
    device: torch.device
    port_cfg: object = None
    host: Dict[str, Dict[str, torch.Tensor]] = None
    buffers: list = None
    expert_bytes: int = 0
    profile: dict = None


def make_weights(st: Setup, buffers: list = None) -> None:
    """Every expert's weights, drawn on the device from the seed, kept in
    page-locked host memory: in ``buffers`` (an earlier seed's of the same
    configuration) where given."""
    layout = reference.family(st.cfg["model_type"]).layout(st.cfg)
    st.host, st.buffers, scratch = {}, [], None
    for i, eid in enumerate(expert_ids(st.cfg)):
        named, buf, scratch = weights.make_expert(
            layout, weights.expert_seed(st.seed, i), st.device, scratch,
            buffers[i] if buffers else None)
        st.host[eid] = named
        st.buffers.append(buf)
    del scratch
    st.expert_bytes = sum(t.numel() * t.element_size()
                          for t in st.host[SAFETY].values())


def build_system(st: Setup, rec: Recorder):
    """The CoE system over the host store, profiled on the mix's prompt
    length; returns (system, coe)."""
    from repro_torch.core import (COSERVE, CoEModel, CoServeSystem,
                                  DeviceProfile, ExecutorSpec, ExpertSpec,
                                  RoutingModule, TierSpec,
                                  microbenchmark_arch)
    from repro_torch.core.engines import HostStore, RealEngine, synchronize

    coe_spec = st.cfg["coe"]
    domains = coe_spec["domains"]
    mem = st.expert_bytes
    store = HostStore()
    for eid, named in st.host.items():
        store.put_host(eid, named)
    experts = [ExpertSpec(id=f"lm_{d}", arch=ARCH, mem_bytes=mem,
                          payload=rec.payload(f"lm_{d}"),
                          usage_prob=1.0 / len(domains)) for d in domains]
    experts.append(ExpertSpec(
        id=SAFETY, arch=ARCH, mem_bytes=mem, payload=rec.payload(SAFETY),
        depends_on=tuple(f"lm_{d}" for d in domains), usage_prob=0.9))
    routing = RoutingModule(
        first_expert_fn=lambda data: f"lm_{data['domain']}",
        next_expert_fn=lambda req, eid, out: (
            SAFETY if eid != SAFETY else None),
        chain_prob={f"lm_{d}": {SAFETY: 1.0} for d in domains})
    coe = CoEModel(experts, routing)
    apply = rec.apply_fn(st.port_cfg)

    s = st.mix["prompt_tokens"]
    sample = {k: v.to(st.device) for k, v in
              st.host[f"lm_{domains[0]}"].items()}

    def run_batch(n):
        x = torch.zeros((n, s), dtype=torch.int32, device=st.device)
        with torch.no_grad():
            apply(sample, x)
            synchronize(st.device)
            t0 = time.perf_counter()
            apply(sample, x)
            synchronize(st.device)
        return time.perf_counter() - t0

    tier = TierSpec(name="lm", unified=True, host_cache_bytes=0,
                    device_bytes=(coe_spec["pool_experts"] + 1) * mem)
    prof = microbenchmark_arch(ARCH, run_batch, mem, s * 4, tier,
                               batch_sizes=(1, 2, 4, 8), repeats=2)
    del sample
    st.profile = {"k": prof.k, "b": prof.b, "max_batch": prof.max_batch,
                  "load_latency_host": prof.load_latency_host}
    dev_prof = DeviceProfile("gpu", tier, {ARCH: prof})
    system = CoServeSystem(
        coe, [ExecutorSpec("gpu", dev_prof, coe_spec["batch_bytes"], "gpu")]
        * coe_spec["executors"],
        {"gpu": coe_spec["pool_experts"] * mem}, policy=COSERVE, tier=tier,
        engine=RealEngine(coe, store, {ARCH: apply}, device=st.device))
    return system, coe


def counters(system) -> dict:
    return {"switches": sum(e.stats.switches for e in system.executors),
            "sched_s": system.sched_time + sum(e.stats.mgmt_time
                                               for e in system.executors),
            "load_s": system.engine.measured_load_time}


def traced_spans(system, spans: Spans) -> None:
    """Name the program's calls the window makes, for the trace's idle
    gaps: scheduling, waits on a load, a batch's execution."""
    spans.wrap(system, "assign", "schedule")
    spans.wrap(system.engine, "wait_load", "load_wait")
    spans.wrap(system.engine, "execute", "execute")


def drive(st: Setup, seconds: float, traced: bool, profiler_factory=None):
    """Build the system, run the warm round and the window; returns the
    window's record, the program's state freed."""
    from repro_torch.core import Request, Simulation

    rec = Recorder(st.device, traced)
    clock = {"built": 0.0, "warm": 0.0}
    t = time.perf_counter()
    system, coe = build_system(st, rec)
    clock["built"] = time.perf_counter() - t
    sim = Simulation(system)
    sim.on_complete = lambda s, req, t: rec.done.__setitem__(
        rec.root(req), time.perf_counter())
    domains = st.cfg["coe"]["domains"]
    vocab = st.cfg["vocab_size"]
    n = st.mix["round_size"]
    domain_of: Dict[int, str] = {}
    submitted: Dict[int, float] = {}

    def run_round(index: int, batch: List[dict]) -> None:
        reqs = []
        for i, item in enumerate(batch):
            rid = index * n + i
            domain_of[rid] = item["domain"]
            reqs.append(Request(id=rid,
                                expert_id=coe.routing.first_expert(item),
                                arrival_time=sim.now, data=item))
        t = time.perf_counter()
        for r in reqs:
            submitted[r.id] = t
        sim.submit(reqs)
        sim.run()

    t = time.perf_counter()
    run_round(0, next(traffic.rounds(st.mix, domains, vocab, st.seed, 0)))
    clock["warm"] = time.perf_counter() - t
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
        torch.cuda.reset_peak_memory_stats(st.device)
    gen = traffic.rounds(st.mix, domains, vocab, st.seed, 1)
    before = counters(system)
    if traced:
        traced_spans(system, rec.spans)
    prof = profiler_factory() if traced else nullcontext()
    rec.window = True
    index = 1
    with prof:
        with rec.spans(traced, "window"):
            t0 = time.perf_counter()
            while True:
                run_round(index, next(gen))
                index += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            t1 = time.perf_counter()
    rec.window = False
    after = counters(system)
    window_ids = [rid for rid in submitted if rid >= n]
    peak = (torch.cuda.max_memory_allocated(st.device)
            if st.device.type == "cuda" else 0)
    record = {
        "cfg": st.cfg, "mix": st.mix,
        "window_s": t1 - t0, "window_start": t0,
        "attempted": len(window_ids),
        "latencies": [rec.done[r] - submitted[r] for r in window_ids
                      if r in rec.done],
        "completed": sum(1 for r in window_ids if r in rec.done),
        "domains": {r: domain_of[r] for r in window_ids},
        "stages": rec.stages, "done": rec.done, "samples": rec.samples,
        "forwards": rec.forwards, "forward_s": rec.forward_s,
        "before": before, "after": after, "expert_bytes": st.expert_bytes,
        "memory_peak_bytes": peak,
        "traced": traced, "profiler": prof if traced else None,
        "spans": rec.spans.by_name,
        "rounds": index - 1, "clock": clock,
    }
    system.engine.device_params.clear()
    del system, sim, coe, rec
    gc.collect()
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
        torch.cuda.empty_cache()
    return record

