"""Composable arrival processes and multi-tenant request streams.

Source of truth: the only generator of online Requests — tenant identity,
deadline stamping (``arrival + slo_seconds``) and the chain-root arrival
anchor are set here once, and every downstream consumer (telemetry, SLO
classification, EDF priority) reads them instead of re-deriving.

Offline evaluation materializes the whole task up front
(``workload.make_task_requests``); the online layer instead *generates*
arrivals lazily so a stream can run indefinitely in O(1) memory:

  interarrival process (Poisson | MMPP bursty | diurnal | load step)
      x  per-tenant payload stream (board-scan order or uniform random)
      ->  heap-merged multi-tenant Request generator

Tenants map onto circuit boards (BOARD_A / BOARD_B): a tenant is a product
line streaming inspection images at its own rate, traffic shape and SLO.
``build_multi_board_coe`` merges several boards into one expert catalog so
heterogeneous tenants share the executors — the contention the SLO/admission
layers manage.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.coe import CoEModel, ExpertSpec, Request, RoutingModule
from repro_torch.core.workload import (BOARD_A, BOARD_B, BoardSpec, active_types,
                                 board_layout, build_board_coe,
                                 component_distribution)

BOARDS = {"A": BOARD_A, "B": BOARD_B}


# --------------------------------------------------------------------------- #
# interarrival processes (generators of gaps, seconds)
# --------------------------------------------------------------------------- #

def poisson_gaps(rate: float, rng: np.random.RandomState) -> Iterator[float]:
    """Memoryless arrivals at ``rate`` req/s."""
    while True:
        yield float(rng.exponential(1.0 / rate))


def bursty_gaps(rate: float, rng: np.random.RandomState,
                burst_factor: float = 8.0, on_fraction: float = 0.2,
                mean_phase_s: float = 2.0) -> Iterator[float]:
    """Two-state MMPP: exponential ON/OFF phases; the ON rate is
    ``burst_factor`` times the OFF rate, scaled so the long-run mean is
    ``rate``. Models camera-line bursts between idle conveyor gaps."""
    lo = rate / (on_fraction * burst_factor + (1.0 - on_fraction))
    hi = burst_factor * lo
    on = False
    phase_left = 0.0
    t_gap = 0.0
    while True:
        lam = hi if on else lo
        gap = float(rng.exponential(1.0 / lam))
        while gap > phase_left:   # phase flips mid-gap: re-draw the remainder
            t_gap += phase_left
            gap = (gap - phase_left) * lam   # residual, rate-normalized
            on = not on
            lam = hi if on else lo
            gap = gap / lam
            mean = mean_phase_s * (on_fraction if on else 1.0 - on_fraction)
            phase_left = float(rng.exponential(mean))
        phase_left -= gap
        yield t_gap + gap
        t_gap = 0.0


def diurnal_gaps(rate: float, rng: np.random.RandomState,
                 period_s: float = 120.0, amplitude: float = 0.8
                 ) -> Iterator[float]:
    """Sinusoidally modulated Poisson (thinning): rate(t) = rate *
    (1 + amplitude * sin(2 pi t / period)). A compressed day/night ramp."""
    lam_max = rate * (1.0 + amplitude)
    t = 0.0
    while True:
        total = 0.0
        while True:
            gap = float(rng.exponential(1.0 / lam_max))
            total += gap
            t += gap
            lam = rate * (1.0 + amplitude * math.sin(2 * math.pi * t / period_s))
            if rng.rand() * lam_max <= lam:
                break
        yield total


def step_gaps(rate_before: float, rate_after: float, t_step: float,
              rng: np.random.RandomState) -> Iterator[float]:
    """Poisson with a rate step at ``t_step`` — the autoscaler's unit test
    signal (load suddenly doubles when a second shift starts)."""
    t = 0.0
    while True:
        lam = rate_before if t < t_step else rate_after
        gap = float(rng.exponential(1.0 / lam))
        t += gap
        yield gap


PROCESSES = ("poisson", "bursty", "diurnal", "step")
REQUEST_CLASSES = ("scan", "random")


def make_gaps(process: str, rate: float, rng: np.random.RandomState,
              **kw) -> Iterator[float]:
    if process == "poisson":
        return poisson_gaps(rate, rng)
    if process == "bursty":
        return bursty_gaps(rate, rng, **kw)
    if process == "diurnal":
        return diurnal_gaps(rate, rng, **kw)
    if process == "step":
        return step_gaps(rate, kw.get("rate_after", 2.0 * rate),
                         kw.get("t_step", 10.0), rng)
    raise ValueError(f"unknown arrival process {process!r} "
                     f"(choose from {PROCESSES})")


# --------------------------------------------------------------------------- #
# tenant specification + payload streams
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One traffic source: a product line with its own board, rate, traffic
    shape, request class and latency SLO."""
    name: str
    board: BoardSpec
    rate: float = 50.0              # mean offered load, req/s
    process: str = "poisson"        # poisson | bursty | diurnal | step
    request_class: str = "scan"     # scan (board-scan locality) | random
    slo_seconds: float = 2.0        # per-request end-to-end latency target
    seed: int = 0
    process_kwargs: Tuple[Tuple[str, object], ...] = ()

    def __post_init__(self):
        if self.process not in PROCESSES:
            raise ValueError(f"unknown arrival process {self.process!r} "
                             f"(choose from {PROCESSES})")
        if self.request_class not in REQUEST_CLASSES:
            raise ValueError(f"unknown request class {self.request_class!r} "
                             f"(choose from {REQUEST_CLASSES})")
        if self.rate <= 0.0:
            raise ValueError(f"tenant {self.name!r}: rate must be positive, "
                             f"got {self.rate}")
        if self.slo_seconds <= 0.0:
            raise ValueError(f"tenant {self.name!r}: slo_seconds must be "
                             f"positive, got {self.slo_seconds}")

    def kwargs(self) -> Dict[str, object]:
        return dict(self.process_kwargs)


def board_payload_stream(board: BoardSpec, seed: int,
                         request_class: str = "scan") -> Iterator[dict]:
    """Endless stream of request payloads for one board.

    ``scan`` visits active component types in shuffled placement order with
    all images of a type adjacent (the locality CoServe's arranging exploits);
    ``random`` draws types independently from the quantity distribution —
    a worst-case tenant with no locality.

    This deliberately parallels ``workload.make_task_requests`` rather than
    sharing its loop: that function's RNG consumption order defines the
    offline paper workload realization, and an infinite generator cannot
    reproduce its draw order without changing those numbers. Keep the
    payload schema (component/outcome/needs_detection/det_expert [+board])
    in sync with it and with ``build_multi_board_coe``'s routing.
    """
    if request_class not in REQUEST_CLASSES:
        raise ValueError(f"unknown request class {request_class!r} "
                         f"(choose from {REQUEST_CLASSES})")
    rng = np.random.RandomState(seed)
    dist = component_distribution(board, 0)
    act = active_types(board, 0)
    probs = dist[act]
    needs_det, det_assign = board_layout(board, 0)
    per_board_total = board.n_active * board.avg_quantity

    def payload(c: int) -> dict:
        ok = bool(rng.rand() < board.ok_prob)
        return {"board": board.name, "component": int(c),
                "outcome": "ok" if ok else "defect",
                "needs_detection": bool(needs_det[c]),
                "det_expert": int(det_assign[c])}

    if request_class == "random":
        p = probs / probs.sum()
        while True:
            yield payload(int(rng.choice(act, p=p)))
    while True:
        order = rng.permutation(act)
        for c in order:
            q = max(1, int(rng.poisson(
                probs[np.searchsorted(act, c)] * per_board_total)))
            for _ in range(q):
                yield payload(int(c))


def tenant_stream(tenant: TenantSpec, ids: Iterator[int],
                  t0: float = 0.0) -> Iterator[Request]:
    """Timestamped Request generator for one tenant (monotone arrivals)."""
    from repro_torch.core.workload import _name_seed
    rng = np.random.RandomState(tenant.seed + _name_seed(tenant.name))
    gaps = make_gaps(tenant.process, tenant.rate, rng, **tenant.kwargs())
    payloads = board_payload_stream(tenant.board, tenant.seed,
                                    tenant.request_class)
    t = t0
    for gap, data in zip(gaps, payloads):
        t += gap
        yield Request(
            id=next(ids),
            expert_id=f"{tenant.board.name}_cls{data['component']:03d}",
            arrival_time=t, task_id=tenant.name, data=data,
            tenant=tenant.name, deadline=t + tenant.slo_seconds,
            root_arrival_time=t)


def merge_streams(streams: Sequence[Iterator[Request]]) -> Iterator[Request]:
    """Heap-merge per-tenant streams into one globally time-ordered stream,
    pulling lazily (one pending request per tenant)."""
    return heapq.merge(*streams, key=lambda r: r.arrival_time)


def multi_tenant_stream(tenants: Sequence[TenantSpec],
                        max_requests: Optional[int] = None
                        ) -> Iterator[Request]:
    ids = itertools.count()
    merged = merge_streams([tenant_stream(t, ids) for t in tenants])
    return itertools.islice(merged, max_requests) \
        if max_requests is not None else merged


# --------------------------------------------------------------------------- #
# multi-board CoE (tenants over different boards share one system)
# --------------------------------------------------------------------------- #

def merge_board_coe(boards: Sequence[BoardSpec],
                    weights: Optional[Sequence[float]] = None
                    ) -> CoEModel:
    """Merge several boards' expert catalogs into one CoE. Expert ids are
    already board-prefixed (``A_cls000``), so distinct boards union
    disjointly; a board named by several tenants appears once with its
    tenants' traffic shares summed. Usage probabilities are scaled by each
    board's total share so initial placement favours the hot experts.

    Prefer the declarative path: a ``DeploymentSpec`` with
    ``model.kind="tenants"`` builds this catalog via
    ``repro_torch.api.build_catalog`` — spec-driven callers get the tenant-rate
    weighting (or ``model.tenant_weights``) for free."""
    if weights is None:
        weights = [1.0] * len(boards)
    total = sum(weights) or 1.0
    share_by_board: Dict[str, float] = {}
    unique_boards: Dict[str, BoardSpec] = {}
    for board, w in zip(boards, weights):
        unique_boards[board.name] = board
        share_by_board[board.name] = \
            share_by_board.get(board.name, 0.0) + w / total

    experts: List[ExpertSpec] = []
    chain_prob: Dict[str, Dict[str, float]] = {}
    for name, board in unique_boards.items():
        sub = build_board_coe(board)
        for spec in sub.experts.values():
            experts.append(dataclasses.replace(
                spec, usage_prob=spec.usage_prob * share_by_board[name]))
        chain_prob.update(sub.routing.chain_prob)

    def first_expert(data) -> str:
        return f"{data['board']}_cls{data['component']:03d}"

    def next_expert(req: Request, eid: str, output) -> Optional[str]:
        d = req.data or {}
        bname = d.get("board", "")
        if eid.startswith(f"{bname}_cls") and d.get("needs_detection") \
                and output == "ok":
            return f"{bname}_det{d['det_expert']:02d}"
        return None

    return CoEModel(experts,
                    RoutingModule(first_expert, next_expert, chain_prob))


def build_multi_board_coe(boards: Sequence[BoardSpec],
                          weights: Optional[Sequence[float]] = None
                          ) -> CoEModel:
    """Deprecated alias of ``merge_board_coe`` (kept so downstream callers
    migrate without breaking): new code should declare the tenant mix in a
    ``DeploymentSpec`` (``model.kind="tenants"``) and let
    ``repro_torch.api.build_catalog`` build the merged catalog."""
    import warnings
    warnings.warn(
        "build_multi_board_coe(...) direct kwargs are deprecated — declare "
        'the tenant mix in a DeploymentSpec (model.kind="tenants") and use '
        "repro_torch.api.build_catalog, or call merge_board_coe for the raw merge",
        DeprecationWarning, stacklevel=2)
    return merge_board_coe(boards, weights)
