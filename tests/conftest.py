import os
import sys

# smoke tests and benches must see ONE device (the dry-run sets its own
# XLA_FLAGS before importing jax; never set device-count flags globally here)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import dataclasses  # noqa: E402

import pytest  # noqa: E402

from repro.core import COSERVE, CoServeSystem, Simulation  # noqa: E402
from repro.core.reference import apply_reference  # noqa: E402
from repro.core.workload import (BoardSpec, build_board_coe,  # noqa: E402
                                 make_executor_specs, make_task_requests)
from repro.memory import NUMA  # noqa: E402

# --------------------------------------------------------------------------- #
# shared small-system builder: every suite that drives a board catalog over a
# tier (simperf/hetero/fleet equivalence, decode) builds through here instead
# of hand-wiring CoServeSystem + Simulation its own way
# --------------------------------------------------------------------------- #

SMALL_BOARD = BoardSpec(name="S", n_components=20, n_active=12,
                        n_detection=4)


def build_board_system(board, tier, n_gpu=3, n_cpu=1, *, policy=COSERVE,
                       links="shared", replication=0, seed=0, tracer=None,
                       decode=None, cpu_multiplier=0.0, gpu_pool_bytes=None):
    """One board catalog on one tier: (pools, specs) from the seed layout
    helper, wired into a CoServeSystem. ``decode`` takes a DecodeConfig for
    token-level runs (None = stage-level, the pre-PR-9 behaviour)."""
    coe = build_board_coe(board, seed=seed)
    pools, specs = make_executor_specs(tier, n_gpu, n_cpu,
                                       gpu_pool_bytes=gpu_pool_bytes,
                                       cpu_multiplier=cpu_multiplier)
    return CoServeSystem(coe, specs, pools, policy=policy, tier=tier,
                         links=links, replication=replication,
                         tracer=tracer, decode=decode)


def record_decisions(system, log):
    """Wrap ``system.assign`` to record every scheduling decision: executor
    choice pins assign; the target queue's (expert, size) profile after
    insertion pins the arrange (join/new-group) call."""
    orig_assign = system.assign

    def recording_assign(req, now):
        ex = orig_assign(req, now)
        log.append((req.expert_id, ex.id,
                    tuple((g.expert_id, len(g)) for g in ex.queue)))
        return ex

    system.assign = recording_assign


def run_board_system(board, tier, *, n_requests=250, interval=0.004,
                     request_seed=None, reference=False, decisions=None,
                     sim_hook=None, seed=0, **build_kw):
    """Build + simulate the paper task stream; returns (Metrics, system).

    ``reference`` swaps in the retained naive scheduler/cost paths
    (``apply_reference``) for bit-identicality pairs; ``decisions`` appends
    the recorded assign/arrange stream; ``sim_hook(sim, system)`` runs
    before submission (tickers, failure injections)."""
    system = build_board_system(board, tier, seed=seed, **build_kw)
    if reference:
        apply_reference(system)
    if decisions is not None:
        record_decisions(system, decisions)
    sim = Simulation(system)
    if sim_hook is not None:
        sim_hook(sim, system)
    rs = seed if request_seed is None else request_seed
    sim.submit(make_task_requests(board, n_requests, interval=interval,
                                  seed=rs))
    return sim.run(), system


def strip_wall_clock(m):
    """Metrics minus the wall-clock fields that legitimately differ
    between two otherwise bit-identical runs."""
    d = dataclasses.asdict(m)
    for k in ("wall_s", "sched_time", "mgmt_time"):
        d.pop(k, None)
    for ex in d.get("per_executor", {}).values():
        if isinstance(ex, dict):
            ex.pop("mgmt_time", None)
    return d


@pytest.fixture
def small_system():
    """A compact 2-GPU + 1-CPU board system on the NUMA tier (function
    scope: simulations mutate pool/queue state)."""
    return build_board_system(SMALL_BOARD, NUMA, n_gpu=2, n_cpu=1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skips "
                   "without one")
