"""The port's LM-expert router against the JAX package's
``examples/lm_coe_router.py``, at the example's smoke width on the CPU, with
the experts of the example (StarCoder2-3B's smoke config) and with
Falcon-Mamba-7B's or Moonlight-16B-A3B's smoke config swapped into the
example's ``cfg`` as ``--arch`` swaps it into the port's.

The seven experts carry the example's own weights (``init_params`` with
PRNG keys 0-5 and 99), converted with ``params_from_reference``; the
requests are the example's draws. Both policies serve all 90 prompts, and
every request's result ("ok"/"flag" of the safety expert's next token) must
equal the example's ``lm_apply`` chain on the same tokens: the draft
expert's on the request, the safety expert's on its follow-up. The next
tokens themselves must be equal for every prompt. Both packages compute in
float32 here: under the example's bfloat16 compute a few prompts in 90
have their top two logits within one bf16 rounding, and the two
frameworks' matmuls round such a tie different ways. With Moonlight's MoE
experts both configs take a capacity factor that makes routing dropless
(experts / top-k): at the published 1.25 a served token depends on the
other prompts of its padded batch, while the example's ``lm_apply`` runs
all 90 prompts in one group; the CLI serves them at 1.25.
"""
import dataclasses
import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_reference
from repro_torch.core import COSERVE, SAMBA_PARALLEL, run_real
from repro_torch.launch import lm_coe_router as router
from test_torch_generate import reference_fields

EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "lm_coe_router.py")


def load_example(arch=None, **changes):
    """A fresh copy of the example module (cfg and lm_apply defined, main()
    unrun), computing in float32, with ``arch``'s smoke config swapped in
    for its experts' when given, and ``changes``. lm_apply reads the
    module's cfg when it is first traced."""
    spec = importlib.util.spec_from_file_location("lm_coe_router_example",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if arch is not None:
        from repro.configs import get_config, smoke_config

        mod.cfg = dataclasses.replace(smoke_config(get_config(arch)),
                                      remat=False)
    mod.cfg = dataclasses.replace(mod.cfg, compute_dtype="float32",
                                  **changes)
    return mod


def example_weights(example):
    from repro.models import transformer as jt

    seeds = dict(zip(router.expert_ids(), [*range(6), 99]))
    return {eid: jt.init_params(jax.random.PRNGKey(seed), example.cfg)
            for eid, seed in seeds.items()}


@pytest.fixture(scope="module")
def example():
    return load_example()


@pytest.fixture(scope="module")
def weights(example):
    return example_weights(example)


def test_config_is_the_examples_with_the_kernel_path(example):
    cfg = router.lm_config("smoke")
    assert cfg.attn_impl == "pallas"
    assert reference_fields(dataclasses.replace(
        cfg, attn_impl="xla", compute_dtype="float32")) \
        == dataclasses.asdict(example.cfg)
    full = router.lm_config("full", layers=2)
    assert (full.d_model, full.num_heads, full.num_kv_heads, full.head_dim,
            full.d_ff, full.vocab_size, full.num_layers) == \
        (3072, 24, 2, 128, 12288, 49152, 2)


def test_router_serves_every_prompt_like_the_example(example, weights):
    check_router(example, weights, "starcoder2_3b")


def test_falcon_mamba_router_serves_every_prompt_like_the_example():
    """``--arch falcon_mamba_7b``: every expert forward runs the selective
    scan on the kernel path (on the CPU its plain version), and the tokens
    are those of the example with the same config swapped in."""
    example = load_example("falcon_mamba_7b")
    assert example.cfg.family == "ssm"
    check_router(example, example_weights(example), "falcon_mamba_7b")


def test_falcon_mamba_config():
    cfg = router.lm_config("smoke", arch="falcon_mamba_7b")
    assert cfg.attn_impl == "pallas" and cfg.param_dtype == "float32"
    assert reference_fields(dataclasses.replace(
        cfg, attn_impl="xla", compute_dtype="float32")) \
        == dataclasses.asdict(load_example("falcon_mamba_7b").cfg)
    full = router.lm_config("full", layers=2, arch="falcon_mamba_7b")
    assert (full.d_model, full.d_inner, full.ssm_state_dim, full.dt_rank,
            full.ssm_conv_width, full.vocab_size, full.num_layers,
            full.param_dtype, full.tie_embeddings) == \
        (4096, 8192, 16, 256, 4, 65024, 2, "bfloat16", True)
    with pytest.raises(ValueError, match="arch must be one of"):
        router.lm_config("smoke", arch="mixtral_8x22b")


def test_moonshot_router_serves_every_prompt_like_the_example():
    """``--arch moonshot_v1_16b_a3b``: every expert forward runs flash
    attention (on the CPU its plain version) and the MoE layer, dropless
    here (see the module's docstring); the tokens are those of the example
    with the same config swapped in."""
    arch = "moonshot_v1_16b_a3b"
    dropless = dict(moe_capacity_factor=2.0)     # 4 experts, top-2
    example = load_example(arch, **dropless)
    assert example.cfg.family == "moe"
    check_router(example, example_weights(example), arch, **dropless)


def test_moonshot_config():
    cfg = router.lm_config("smoke", arch="moonshot_v1_16b_a3b")
    assert cfg.attn_impl == "pallas" and cfg.param_dtype == "float32"
    assert reference_fields(dataclasses.replace(
        cfg, attn_impl="xla", compute_dtype="float32")) \
        == dataclasses.asdict(load_example("moonshot_v1_16b_a3b").cfg)
    full = router.lm_config("full", layers=2, arch="moonshot_v1_16b_a3b")
    assert (full.d_model, full.num_heads, full.num_kv_heads, full.head_dim,
            full.moe_num_experts, full.moe_top_k, full.moe_d_ff,
            full.moe_capacity_factor, full.vocab_size, full.num_layers,
            full.param_dtype) == \
        (2048, 16, 16, 128, 64, 6, 1408, 1.25, 163840, 2, "bfloat16")
    assert full.param_count() == 1_812_211_712      # 3.62 GB in bf16


def check_router(example, weights, arch, **changes):
    """Both policies serve all 90 prompts; every request's result and its
    safety follow-up's equal the example's lm_apply chain on its tokens."""
    cfg = dataclasses.replace(router.lm_config("smoke", arch=arch),
                              compute_dtype="float32", **changes)
    params = {eid: params_from_reference(jax.tree.map(np.asarray, p))
              for eid, p in weights.items()}
    rng = np.random.RandomState(0)
    store = None
    try:
        for policy in (COSERVE, SAMBA_PARALLEL):
            system, coe = router.build_lm_system(
                cfg, policy, device="cpu", params=params, store=store)
            store = system.engine.store
            assert sorted(store.disk) == ["lm_chat", "lm_finance", "lm_math",
                                          "lm_safety"]
            assert coe.spec("lm_safety").depends_on == tuple(
                f"lm_{d}" for d in router.DOMAINS)
            follow = {}
            route = system.route_followup

            def capture(req, eid, out):
                nxt = route(req, eid, out)
                if nxt is not None:
                    follow[req.id] = nxt
                return nxt

            system.route_followup = capture
            reqs = router.make_requests(rng, cfg)
            m = run_real(system, reqs)
            assert m.completed == len(reqs) == router.N_REQS
            assert sorted(follow) == [r.id for r in reqs]   # every chain

            prompts = np.stack([r.data["tokens"] for r in reqs])
            lm_apply = router.make_lm_apply(cfg)
            want = {eid: np.asarray(example.lm_apply(weights[eid],
                                                     jnp.asarray(prompts)))
                    for eid in router.expert_ids()}
            for eid in ("lm_safety", reqs[0].expert_id):
                with torch.no_grad():
                    got = lm_apply(params[eid], torch.from_numpy(prompts))
                np.testing.assert_array_equal(got.numpy(), want[eid])
            interpret = router.PAYLOAD["interpret"]
            for i, r in enumerate(reqs):
                # the draft's result, then the safety check's on the chain
                assert r.result == interpret(want[r.expert_id][i:i + 1])[0]
                assert follow[r.id].expert_id == "lm_safety"
                assert follow[r.id].result == \
                    interpret(want["lm_safety"][i:i + 1])[0]
    finally:
        shutil.rmtree(store.root, ignore_errors=True)


def test_cli_reports_both_policies(capsys):
    report = router.main(["--device", "cpu", "--requests", "12"])
    assert report["arch"] == "starcoder2_3b"
    assert [p["policy"] for p in report["policies"]] == [
        COSERVE.name, SAMBA_PARALLEL.name]
    assert all(p["completed"] == 12 for p in report["policies"])
    assert report["layers"] == 2 and not report["layers_cut"]
    assert capsys.readouterr().out.count("makespan_s") == 2


def test_cli_serves_falcon_mamba_experts(capsys):
    report = router.main(["--device", "cpu", "--requests", "12", "--arch",
                          "falcon_mamba_7b", "--layers", "1"])
    assert report["arch"] == "falcon_mamba_7b"
    assert report["layers"] == 1 and report["layers_cut"]
    assert all(p["completed"] == 12 for p in report["policies"])
    assert capsys.readouterr().out.count("makespan_s") == 2


def test_cli_serves_moonshot_experts(capsys):
    """Moonlight's smoke experts at the published capacity factor 1.25:
    every prompt is served under both policies."""
    report = router.main(["--device", "cpu", "--requests", "12", "--arch",
                          "moonshot_v1_16b_a3b"])
    assert report["arch"] == "moonshot_v1_16b_a3b"
    assert report["layers"] == 2 and not report["layers_cut"]
    assert all(p["completed"] == 12 for p in report["policies"])
    assert capsys.readouterr().out.count("makespan_s") == 2
