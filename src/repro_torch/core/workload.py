"""Paper evaluation workload: circuit-board defect inspection (paper §5.1).

Boards A (352 component types) and B (342): one dedicated classification
expert per component (ResNet101-class), a shared object-detection expert
(YOLOv5m/l-class) for the component types that need alignment verification.
A component image arrives every 4 ms; tasks are 2,500 / 3,500 requests.

Default performance profiles encode the paper's NUMA (RTX3080Ti-class) and
UMA (Apple-M2-class) devices; the real profiler replaces them when measured
numbers are available (``profiler.microbenchmark_arch``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.coe import CoEModel, ExpertSpec, Request, RoutingModule
from repro_torch.core.profiler import ArchProfile, DeviceProfile
from repro_torch.core.serving import ExecutorSpec
from repro_torch.memory import NUMA, UMA, TierSpec
from repro_torch.memory.transfer import predicted_load_latency as load_latency

MB = 1 << 20

# parameter footprints (fp32 serialized, matching the paper's ~60 GB / 300+
# experts: ResNet101 ~44.5M params -> ~178 MB)
ARCH_BYTES = {
    "resnet101": 178 * MB,
    "yolov5m": 85 * MB,
    "yolov5l": 185 * MB,
}

# (K, B) seconds per device kind; CPU is ~8-20x slower (paper Fig. 5)
_EXEC_CONSTANTS = {
    ("resnet101", "gpu"): (0.005, 0.020),
    ("resnet101", "cpu"): (0.055, 0.045),
    ("yolov5m", "gpu"): (0.004, 0.016),
    ("yolov5m", "cpu"): (0.045, 0.040),
    ("yolov5l", "gpu"): (0.007, 0.026),
    ("yolov5l", "cpu"): (0.080, 0.055),
}

# per-item activation bytes (paper §3.3: one ResNet101 batch item costs as
# much memory as ~1.5 experts on the NUMA GPU)
_ACT_BYTES = {
    ("resnet101", "gpu"): 260 * MB,
    ("resnet101", "cpu"): 180 * MB,
    ("yolov5m", "gpu"): 200 * MB,
    ("yolov5m", "cpu"): 140 * MB,
    ("yolov5l", "gpu"): 300 * MB,
    ("yolov5l", "cpu"): 200 * MB,
}

_MAX_BATCH = {"gpu": 8, "cpu": 5}


def _cpu_constants(arch: str, tier: TierSpec,
                   cpu_multiplier: float = 0.0) -> Tuple[float, float]:
    """The CPU service-time line (K, B) for one architecture: derived from
    the device time by ``cpu_multiplier`` when set (the sim-mode hetero
    knob), else the paper's measured CPU constants; NUMA DRAM contention adds
    the same 10% the static table applies."""
    if cpu_multiplier > 0:
        gk, gb = _EXEC_CONSTANTS[(arch, "gpu")]
        k, b = gk * cpu_multiplier, gb * cpu_multiplier
    else:
        k, b = _EXEC_CONSTANTS[(arch, "cpu")]
    if not tier.unified:
        k *= 1.1
    return k, b


def default_arch_profile(arch: str, device: str, tier: TierSpec,
                         cpu_multiplier: float = 0.0) -> ArchProfile:
    k, b = _EXEC_CONSTANTS[(arch, device)]
    mem = ARCH_BYTES[arch]
    cpu_k, cpu_b = _cpu_constants(arch, tier, cpu_multiplier)
    if device == "cpu":
        k, b = cpu_k, cpu_b
    return ArchProfile(
        arch=arch, k=k, b=b, max_batch=_MAX_BATCH[device],
        mem_bytes=mem, act_bytes_per_item=_ACT_BYTES[(arch, device)],
        load_latency_host=load_latency(tier, mem, in_host_cache=True),
        load_latency_disk=load_latency(tier, mem, in_host_cache=False),
        cpu_k=cpu_k, cpu_b=cpu_b,
    )


def device_profile(device: str, tier: TierSpec,
                   cpu_multiplier: float = 0.0) -> DeviceProfile:
    archs = {a: default_arch_profile(a, device, tier, cpu_multiplier)
             for a in ARCH_BYTES}
    return DeviceProfile(device=device, tier=tier, arch_profiles=archs)


# --------------------------------------------------------------------------- #
# CoE model for a circuit board
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class BoardSpec:
    """A circuit-board product: the expert *catalog* covers every component
    type ever used (352/342 dedicated classifiers -> ~60 GB of experts), while
    one concrete board design populates ``n_active`` of them; each board
    instance is scanned component-type by component-type (images of the same
    type are adjacent in the scan), ``avg_quantity`` images per type."""
    name: str
    n_components: int                # catalog size (= #classification experts)
    n_active: int = 120              # component types on this board design
    avg_quantity: float = 3.0        # images per active type per board
    n_detection: int = 24            # shared detection experts
    detection_fraction: float = 0.4  # component types needing verification
    ok_prob: float = 0.95            # classifier outcome triggering detection
    zipf_s: float = 1.1              # skew of per-type quantities


BOARD_A = BoardSpec(name="A", n_components=352)
BOARD_B = BoardSpec(name="B", n_components=342)


def _name_seed(name: str) -> int:
    """Deterministic name hash: ``hash()`` is per-process randomized
    (PYTHONHASHSEED), which silently changed workloads across runs."""
    import zlib
    return zlib.crc32(name.encode()) % 1000


def active_types(board: BoardSpec, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed + _name_seed(board.name))
    return np.sort(rng.choice(board.n_components, board.n_active,
                              replace=False))


def component_distribution(board: BoardSpec, seed: int = 0) -> np.ndarray:
    """Known component-quantity distribution over the catalog (paper §4.5):
    zero off-board, Zipf-skewed quantities across the active types."""
    rng = np.random.RandomState(seed + _name_seed(board.name))
    act = active_types(board, seed)
    ranks = np.arange(1, board.n_active + 1, dtype=np.float64)
    w = ranks ** (-board.zipf_s)
    rng.shuffle(w)
    dist = np.zeros(board.n_components)
    dist[act] = w / w.sum()
    return dist


def board_layout(board: BoardSpec, seed: int = 0):
    """Deterministic component->detection wiring shared by the CoE builder
    and the request generator."""
    rng = np.random.RandomState(seed)
    needs_det = rng.rand(board.n_components) < board.detection_fraction
    det_assign = rng.randint(0, board.n_detection, board.n_components)
    return needs_det, det_assign


def build_board_coe(board: BoardSpec, seed: int = 0) -> CoEModel:
    dist = component_distribution(board, seed)
    needs_det, det_assign = board_layout(board, seed)
    det_arch = ["yolov5m" if i % 2 == 0 else "yolov5l"
                for i in range(board.n_detection)]

    experts: List[ExpertSpec] = []
    chain_prob: Dict[str, Dict[str, float]] = {}
    det_upstream: Dict[int, List[str]] = {i: [] for i in range(board.n_detection)}
    for c in range(board.n_components):
        cid = f"{board.name}_cls{c:03d}"
        deps: Tuple[str, ...] = ()
        if needs_det[c]:
            det_upstream[det_assign[c]].append(cid)
            chain_prob[cid] = {f"{board.name}_det{det_assign[c]:02d}": board.ok_prob}
        experts.append(ExpertSpec(
            id=cid, arch="resnet101", mem_bytes=ARCH_BYTES["resnet101"],
            depends_on=deps))
    for dnum in range(board.n_detection):
        did = f"{board.name}_det{dnum:02d}"
        experts.append(ExpertSpec(
            id=did, arch=det_arch[dnum], mem_bytes=ARCH_BYTES[det_arch[dnum]],
            depends_on=tuple(det_upstream[dnum])))

    def first_expert(data) -> str:
        return f"{board.name}_cls{data['component']:03d}"

    def next_expert(req: Request, eid: str, output) -> Optional[str]:
        d = req.data
        if eid.startswith(f"{board.name}_cls") and d.get("needs_detection") \
                and output == "ok":
            return f"{board.name}_det{d['det_expert']:02d}"
        return None

    routing = RoutingModule(first_expert, next_expert, chain_prob)
    coe = CoEModel(experts, routing)
    # pre-assess usage probabilities from the known component distribution
    # (paper §4.5: predefined routing rules + known quantity distribution)
    coe = coe.assess_usage_probabilities(
        {DistData(c): float(dist[c]) for c in range(board.n_components)})
    return coe


class DistData(dict):
    """Hashable request-data stand-in for probability assessment."""
    def __init__(self, component: int):
        super().__init__(component=component)
        self._c = component

    def __hash__(self):
        return hash(self._c)

    def __eq__(self, other):
        return isinstance(other, DistData) and other._c == self._c


def make_task_requests(board: BoardSpec, n_requests: int,
                       interval: float = 0.004, seed: int = 1,
                       task_id: str = "") -> List[Request]:
    """Paper tasks: continuous stream, one component image every 4 ms.

    The stream is a sequence of *board scans*: per board instance the active
    component types are visited in (shuffled) placement order, with all
    images of one type adjacent, quantities drawn around the known
    distribution. This cyclic sweep is what makes FCFS+LRU thrash (§3.1/3.2)
    while CoServe's arranging merges the same type across queued boards.
    """
    rng = np.random.RandomState(seed)
    dist = component_distribution(board, 0)
    act = active_types(board, 0)
    probs = dist[act]
    needs_det, det_assign = board_layout(board, 0)
    per_board_total = board.n_active * board.avg_quantity

    comps: List[int] = []
    while len(comps) < n_requests:
        order = rng.permutation(act)
        for c in order:
            q = max(1, int(rng.poisson(probs[np.searchsorted(act, c)]
                                       * per_board_total)))
            comps.extend([int(c)] * q)
            if len(comps) >= n_requests:
                break
    comps = comps[:n_requests]

    oks = rng.rand(n_requests) < board.ok_prob
    reqs = []
    for i, (c, ok) in enumerate(zip(comps, oks)):
        reqs.append(Request(
            id=i, expert_id=f"{board.name}_cls{c:03d}",
            arrival_time=i * interval, task_id=task_id or board.name,
            data={"component": int(c), "outcome": "ok" if ok else "defect",
                  "needs_detection": bool(needs_det[c]),
                  "det_expert": int(det_assign[c])}))
    return reqs


# --------------------------------------------------------------------------- #
# executor/pool builders
# --------------------------------------------------------------------------- #

def make_executor_specs(tier: TierSpec, n_gpu: int, n_cpu: int,
                        pool_fraction: float = 0.75,
                        gpu_pool_bytes: Optional[int] = None,
                        cpu_multiplier: float = 0.0
                        ) -> Tuple[Dict[str, int], List[ExecutorSpec]]:
    """Build (pools, executor specs) for a device.

    Executors on the same physical device share one expert pool (the paper's
    multi-executor single-GPU setup); device memory is split pool/batch by
    ``pool_fraction`` (CoServe-Casual default 75/25), with the batch region
    divided between that device's executors. ``gpu_pool_bytes`` overrides the
    accelerator pool size (CoServe-Best: set from the decay-window search).
    ``cpu_multiplier`` > 0 derives the CPU service-time model from the
    device time instead of the static constants (``hetero.cpu_multiplier``).
    """
    pools: Dict[str, int] = {}
    specs: List[ExecutorSpec] = []
    gpu_prof = device_profile("gpu", tier, cpu_multiplier)
    cpu_prof = device_profile("cpu", tier, cpu_multiplier)

    if tier.unified:
        gpu_region = tier.device_bytes * n_gpu // max(1, n_gpu + n_cpu)
        cpu_region = tier.device_bytes - gpu_region
    else:
        gpu_region = tier.device_bytes
        cpu_region = tier.host_cache_bytes // 2   # CPU executors run from DRAM

    if n_gpu:
        pool = gpu_pool_bytes if gpu_pool_bytes is not None \
            else int(gpu_region * pool_fraction)
        pools["gpu"] = pool
        batch_each = (gpu_region - pool) // n_gpu
        for _ in range(n_gpu):
            specs.append(ExecutorSpec("gpu", gpu_prof, batch_each, "gpu"))
    if n_cpu:
        pool = int(cpu_region * pool_fraction)
        pools["cpu"] = pool
        batch_each = (cpu_region - pool) // n_cpu
        for _ in range(n_cpu):
            specs.append(ExecutorSpec("cpu", cpu_prof, batch_each, "cpu"))
    return pools, specs
