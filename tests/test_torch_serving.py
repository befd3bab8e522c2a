"""The whole slice on the CPU: the port's real-expert server with token decode
against the JAX package's, on the reference's weights converted.

Both packages serve the same 8 requests (each built with its own package's
``Request``) with ``DecodeConfig(tokens=4, tokens_dist="fixed")``. Every
request completes in both, each request's chain of experts and their
outcomes are equal, ``tokens_out`` is equal, and each final decode result
agrees within 2e-5 (fp32 ring; the Pallas kernel and the plain version
round the q scaling differently). Executor choice and switch counts follow
measured wall time, so they are not compared.

The CLI prints the reference's result-dict keys in ``--mode real`` and
``--mode online --engine real``, and a 100-request ``--mode sim`` run gives
the reference's result dict exactly.
"""
import contextlib
import io

import jax
import numpy as np
import pytest

from repro.api import build as jbuild
from repro.core import coe as jcoe
from repro.core import decode as jdecode
from repro.core import simulator as jsim
from repro.launch import serve as jserve
from repro_torch.api import build as tbuild
from repro_torch.convert import params_from_reference
from repro_torch.core import coe as tcoe
from repro_torch.core import decode as tdecode
from repro_torch.core import simulator as tsim
from repro_torch.launch import serve as tserve

N_COMPONENTS, N_DETECTION = 12, 2
SYSTEM = dict(n_components=N_COMPONENTS, n_detection=N_DETECTION,
              pool_experts=4, n_executors=2, d_hidden=64)


def reference_params():
    """The reference's own expert weights (build_real_system's key
    schedule), as the port's flat tensor dicts."""
    keys = jax.random.split(jax.random.PRNGKey(0), N_COMPONENTS + N_DETECTION)
    ids = [f"cls{c:03d}" for c in range(N_COMPONENTS)] \
        + [f"det{d:02d}" for d in range(N_DETECTION)]
    return {eid: params_from_reference(
        {k: np.asarray(v) for k, v in jbuild._tiny_params(
            keys[i], 64, SYSTEM["d_hidden"], 2).items()})
        for i, eid in enumerate(ids)}


def make_requests(request_cls, n=8):
    rng = np.random.RandomState(5)
    needs_det, det_assign = jbuild.real_board_layout(N_COMPONENTS,
                                                     N_DETECTION)
    reqs = []
    for i in range(n):
        c = int(rng.randint(N_COMPONENTS))
        reqs.append(request_cls(
            id=i, expert_id=f"cls{c:03d}",
            data={"component": c, "x": rng.randn(64).astype(np.float32),
                  "needs_detection": bool(needs_det[c]),
                  "det_expert": int(det_assign[c])}))
    return reqs


def serve(sim_mod, system, reqs):
    """``run_real``'s drive (all arrivals at t=0) with the per-stage hook
    recording each request's chain: root id -> [(expert, outcome)]."""
    sim = sim_mod.Simulation(system)
    chains = {}

    def on_stage(sim, req, eid, now):
        root = req.parent_id if req.parent_id is not None else req.id
        chains.setdefault(root, []).append((eid, req.result))

    sim.on_stage = on_stage
    for r in reqs:
        r.arrival_time = 0.0
        sim.push(0.0, sim_mod.ARRIVAL, r)
    metrics = sim.run()
    finals = {(r.parent_id if r.parent_id is not None else r.id): r.result
              for r in sim.completed}
    return metrics, chains, finals


@pytest.fixture(scope="module")
def both_served():
    jsys, _ = jbuild.build_real_system(
        **SYSTEM, decode=jdecode.DecodeConfig(tokens=4, tokens_dist="fixed"))
    tsys, _ = tbuild.build_real_system(
        **SYSTEM, decode=tdecode.DecodeConfig(tokens=4, tokens_dist="fixed"),
        device="cpu", params=reference_params())
    return (serve(jsim, jsys, make_requests(jcoe.Request)),
            serve(tsim, tsys, make_requests(tcoe.Request)))


def test_every_request_completes_in_both(both_served):
    (jm, _, jfin), (tm, _, tfin) = both_served
    assert jm.completed == tm.completed == 8
    assert sorted(jfin) == sorted(tfin) == list(range(8))


def test_expert_chains_and_outcomes_are_equal(both_served):
    (_, jchains, _), (_, tchains, _) = both_served
    assert tchains == jchains
    assert any(len(c) == 2 for c in jchains.values())   # a det follow-up ran


def test_decode_token_counts_are_equal(both_served):
    (jm, _, _), (tm, _, _) = both_served
    assert jm.decode["tokens_out"] == tm.decode["tokens_out"] == 8 * 4


def test_final_decode_results_agree(both_served):
    (_, _, jfin), (_, _, tfin) = both_served
    for rid, want in jfin.items():
        got = tfin[rid]
        assert isinstance(got, np.ndarray) and got.shape == (4, 64)
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=2e-5, atol=2e-5)


def _run_both(argv):
    with contextlib.redirect_stdout(io.StringIO()):
        want = jserve.main(argv + ["--quiet"])
        got = tserve.main(argv + ["--quiet", "--device", "cpu"])
    return want, got


@pytest.mark.parametrize("argv", [
    ["--mode", "real", "--requests", "6"],
    ["--mode", "real", "--decode", "--decode-tokens", "2", "--requests", "4"],
    ["--mode", "online", "--engine", "real", "--requests", "8"],
], ids=["real", "real-decode", "online-real"])
def test_cli_result_keys_match_reference(argv):
    want, got = _run_both(argv)
    assert list(got) == list(want)
    assert got["completed"] == want["completed"]
    if "decode" in want:
        assert list(got["decode"]) == list(want["decode"])
        assert got["decode"]["tokens_out"] == want["decode"]["tokens_out"]


def test_cli_sim_mode_equals_reference_exactly():
    want, got = _run_both(["--mode", "sim", "--requests", "100"])
    assert got == want
