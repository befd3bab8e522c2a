"""Offline profiler (paper §4.4–§4.5).

Produces, per (device kind x expert architecture):
  - max batch size      (avg-latency plateau over a batch sweep, Fig. 5)
  - execution latency   (K, B of ``latency = K*n + B``, Fig. 12)
  - load latency        (expert switch cost per source tier)
  - memory footprint    (params + per-item activation bytes -> memory score)
and, per device, the expert-pool/batch-memory split via the decay-window
search on the usage-probability CDF (Eq. 1–3, Fig. 11/18).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.coe import CoEModel
from repro_torch.memory import TierSpec
from repro_torch.memory.transfer import predicted_load_latency


@dataclasses.dataclass
class ArchProfile:
    """Performance matrix entry for one expert architecture on one processor.
    Same-architecture experts share one profile (paper §4.5)."""
    arch: str
    k: float                  # marginal latency per request in a batch [s]
    b: float                  # batch setup latency [s]
    max_batch: int
    mem_bytes: int            # parameter bytes
    act_bytes_per_item: int   # intermediate-result bytes per batched item
    load_latency_host: float = 0.0   # host cache -> device
    load_latency_disk: float = 0.0   # disk -> device
    # CPU service-time model (heterogeneous co-execution): what the SAME
    # architecture costs on the host CPU pool — measured by
    # ``microbenchmark_arch(run_batch_cpu=...)`` in real mode, derived from
    # the device time via ``hetero.cpu_multiplier`` in sim. 0.0 = unprofiled
    # (host co-execution then keeps the static CPU constants).
    cpu_k: float = 0.0
    cpu_b: float = 0.0

    def exec_latency(self, n: int) -> float:
        return self.k * n + self.b if n > 0 else 0.0

    def cpu_exec_latency(self, n: int) -> float:
        """Linear CPU service-time model K·n+B of this architecture on the
        host pool (0.0 when no CPU profile was taken)."""
        return self.cpu_k * n + self.cpu_b if n > 0 else 0.0


@dataclasses.dataclass
class DeviceProfile:
    """All profiling results for one executor device kind."""
    device: str                       # "tpu" | "host" (paper: GPU | CPU)
    tier: TierSpec
    arch_profiles: Dict[str, ArchProfile]
    pool_bytes: int = 0               # expert-loading share of device memory
    batch_bytes: int = 0              # activation share

    def profile(self, arch: str) -> ArchProfile:
        return self.arch_profiles[arch]


# --------------------------------------------------------------------------- #
# microbenchmarks (paper §4.5)
# --------------------------------------------------------------------------- #

def fit_latency_line(batch_sizes: Sequence[int], latencies: Sequence[float]
                     ) -> Tuple[float, float]:
    """Least-squares fit of latency = K*n + B."""
    a = np.vstack([np.asarray(batch_sizes, float), np.ones(len(batch_sizes))]).T
    k, b = np.linalg.lstsq(a, np.asarray(latencies, float), rcond=None)[0]
    return float(k), float(b)


def find_max_batch(batch_sizes: Sequence[int], latencies: Sequence[float],
                   plateau_eps: float = 0.03) -> int:
    """Max batch = where average (per-item) latency plateaus (paper Fig. 5):
    the first batch size whose avg-latency improvement over the previous
    sweep point falls below ``plateau_eps`` (relative)."""
    avg = [l / n for n, l in zip(batch_sizes, latencies)]
    for i in range(1, len(avg)):
        if avg[i - 1] <= 0:
            continue
        improvement = (avg[i - 1] - avg[i]) / avg[i - 1]
        if improvement < plateau_eps:
            return batch_sizes[i - 1]
    return batch_sizes[-1]


def microbenchmark_arch(
        arch: str,
        run_batch: Callable[[int], float],
        mem_bytes: int,
        act_bytes_per_item: int,
        tier: TierSpec,
        batch_sizes: Sequence[int] = (1, 2, 3, 4, 6, 8, 12, 16),
        repeats: int = 3,
        run_batch_cpu: Optional[Callable[[int], float]] = None,
) -> ArchProfile:
    """Profile one architecture with a real runner (``run_batch(n)`` executes
    a batch of n and returns seconds; called on real samples).
    ``run_batch_cpu`` (heterogeneous co-execution) runs the same batch on the
    host CPU pool; when given, the profile carries a measured CPU
    service-time line (``cpu_k``/``cpu_b``) next to the device one."""
    lats = []
    for n in batch_sizes:
        samples = [run_batch(n) for _ in range(repeats)]
        lats.append(float(np.median(samples)))
    k, b = fit_latency_line(batch_sizes, lats)
    max_batch = find_max_batch(batch_sizes, lats)
    cpu_k = cpu_b = 0.0
    if run_batch_cpu is not None:
        cpu_lats = []
        for n in batch_sizes:
            samples = [run_batch_cpu(n) for _ in range(repeats)]
            cpu_lats.append(float(np.median(samples)))
        cpu_k, cpu_b = fit_latency_line(batch_sizes, cpu_lats)
    return ArchProfile(
        arch=arch, k=k, b=b, max_batch=max_batch, mem_bytes=mem_bytes,
        act_bytes_per_item=act_bytes_per_item,
        cpu_k=cpu_k, cpu_b=cpu_b,
        # per-tier switch costs come from the one TransferEngine formula
        load_latency_host=predicted_load_latency(tier, mem_bytes,
                                                 in_host_cache=True),
        load_latency_disk=predicted_load_latency(tier, mem_bytes,
                                                 in_host_cache=False),
    )


# --------------------------------------------------------------------------- #
# memory allocation (paper §4.4)
# --------------------------------------------------------------------------- #

def allocate_limited_compute(device_bytes: int, coe: CoEModel,
                             profile: ArchProfile) -> Tuple[int, int]:
    """Weak processors: reserve activation memory for the max batch, give all
    the rest to the expert pool."""
    batch_bytes = profile.max_batch * profile.act_bytes_per_item
    return device_bytes - batch_bytes, batch_bytes


@dataclasses.dataclass
class DecayWindowResult:
    n_experts: int
    window: Tuple[int, int]
    history: List[Tuple[int, float]]    # (upper_bound, throughput) samples
    linear_error: float


def decay_window_search(
        throughput_fn: Callable[[int], float],
        max_experts: int,
        initial_window: int = 15,
        error_margin: float = 0.05,
        fit_points: int = 3,
        rng: Optional[np.random.RandomState] = None,
) -> DecayWindowResult:
    """Sliding decay window on the expert-usage CDF (paper Eq. 1–3, Fig. 11).

    ``throughput_fn(n)`` runs sample inference with the top-n experts loaded
    (a smaller representative dataset) and returns throughput. The window
    shrinks by ``decay = 1 - initial_window/100`` each slide; sliding stops
    when the measured throughput falls below the linear-fit prediction by
    more than ``error_margin``; the result is drawn inside the final window.
    """
    rng = rng or np.random.RandomState(0)
    decay = 1.0 - initial_window / 100.0
    window_size = float(initial_window)
    lower, upper = 0, initial_window
    history: List[Tuple[int, float]] = []
    linear_error = 0.0

    while upper < max_experts:
        n = min(upper, max_experts)
        history.append((n, throughput_fn(n)))
        if len(history) >= fit_points + 1:
            xs = np.array([h[0] for h in history[:-1]], float)
            ys = np.array([h[1] for h in history[:-1]], float)
            k, b = np.polyfit(xs, ys, 1)
            predicted = k * history[-1][0] + b
            actual = history[-1][1]
            if predicted > 0:
                linear_error = (predicted - actual) / predicted
                if linear_error > error_margin:
                    break
        window_size = max(1.0, window_size * decay)
        lower = upper
        upper = upper + int(round(window_size))
    else:
        lower, upper = max(0, max_experts - int(round(window_size))), max_experts

    upper = min(upper, max_experts)
    lower = min(lower, upper)
    # The paper samples uniformly inside the final window ("differences ...
    # are negligible"). When the batch-memory cliff is sharp that assumption
    # fails, so we pick the best MEASURED boundary inside the window instead
    # — strictly better and free (beyond-paper; recorded in EXPERIMENTS.md).
    in_window = [(n, t) for n, t in history if lower <= n <= upper]
    if in_window:
        n_experts = max(in_window, key=lambda h: h[1])[0]
    else:
        n_experts = int(rng.randint(lower, upper + 1)) if upper > lower else upper
    n_experts = max(1, n_experts)
    return DecayWindowResult(n_experts=n_experts, window=(lower, upper),
                             history=history, linear_error=float(linear_error))


def pool_split_from_expert_count(coe: CoEModel, n_experts: int,
                                 device_bytes: int) -> Tuple[int, int]:
    """Reserve pool bytes for the top-n experts by usage; rest to batches."""
    top = coe.by_usage()[:n_experts]
    pool = sum(e.mem_bytes for e in top)
    pool = min(pool, device_bytes)
    return pool, device_bytes - pool
