"""The port's LM stack with MoE layers against ``repro.models``: the smoke
configs of Mixtral-8x22B (MoE in every layer, a sliding window) and
Moonlight-16B-A3B (``moonshot_v1_16b_a3b``, MoE in every layer). The checks
are shared with ``test_torch_moe_hybrid.py``, which runs them on Jamba-v0.1
with its MoE on (one period of eight slots: seven mamba and one attention
mixer, MoE FFNs on the odd slots); the two files keep each near 20 s.

Weights are the reference's ``init_params`` converted with
``params_from_reference``; tokens come from numpy seeds; the helpers are
those of ``test_torch_models.py``. The port runs ``attn_impl`` "xla" and
"pallas" (on the CPU the kernels' plain versions); the reference runs its
XLA path, and in one case its Pallas path (interpret mode). At these sizes
every MoE group has at most 64 tokens, so routing is dropless in both
packages. Tolerances: float32 logits 1e-5 as in ``test_torch_models.py``;
the forward's aux loss, a sum over the MoE layers of terms whose inputs
already differ by float32 roundings, 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.models import encdec as jencdec
from repro.models import sampling as jsampling
from repro.models import transformer as jt
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import (flatten_params, nest_params,
                                 params_from_reference)
from repro_torch.models import sampling, transformer
from test_torch_generate import check_init_layout
from test_torch_models import cfgs, close, tokens
from test_torch_ssm_models import jdecode, jforward, jprefill

MOE = ["mixtral_8x22b", "moonshot_v1_16b_a3b", "jamba_v0_1_52b"]
ARCHS = MOE[:2]            # jamba's are in test_torch_moe_hybrid.py


def moe_changes(arch):
    """The smoke config's own experts (``test_torch_models`` switches
    jamba's off)."""
    return dict(moe_num_experts=smoke_config(get_config(arch)).moe_num_experts)


def mcfgs(arch, **changes):
    return cfgs(arch, **moe_changes(arch), **changes)


_REF = {}


def ref_params(arch):
    if arch not in _REF:
        jcfg, _ = mcfgs(arch)
        jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
        _REF[arch] = jp, nest_params(params_from_reference(
            jax.tree.map(np.asarray, jp)))
    return _REF[arch]


_JAX_RUN = {}


def jax_run(arch):
    """The reference's forward (logits and aux), prefill and two decode
    steps on ``arch``, computed once for both of the port's paths."""
    if arch not in _JAX_RUN:
        jcfg, _ = mcfgs(arch, attn_impl="xla")
        jp, _ = ref_params(arch)
        toks = tokens(1, 2, 12)
        logits, aux = jforward(jp, jnp.asarray(toks), cfg=jcfg, mode="eval")
        out, cache = jprefill(jp, jnp.asarray(toks), jcfg, 16)
        steps = []
        for pos in (12, 13):
            step, cache = jdecode(jp, jnp.asarray(toks[:, pos - 12:
                                                       pos - 11]),
                                  jnp.int32(pos), cache, jcfg)
            steps.append(step)
        _JAX_RUN[arch] = toks, [logits, out, *steps], float(aux), cache
    return _JAX_RUN[arch]


def test_configs_route_as_published():
    """MoE slots where the configs put them: every layer of Mixtral and
    Moonlight, Jamba's odd slots."""
    for arch in ARCHS:
        _, tcfg = mcfgs(arch)
        assert [s.ffn for s in tcfg.block_pattern()] == ["moe"]
    _, tcfg = mcfgs("jamba_v0_1_52b")
    assert [(s.mixer, s.ffn) for s in tcfg.block_pattern()] == [
        ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"),
        ("mamba", "moe"), ("attn", "mlp"), ("mamba", "moe"),
        ("mamba", "mlp"), ("mamba", "moe")]


def check_forward_prefill_decode_logits(arch, impl):
    """The port's path ``impl`` against the reference's XLA path: forward
    logits and aux loss, prefill, two decode steps, every cache entry."""
    _, tcfg = mcfgs(arch, attn_impl=impl)
    _, tp = ref_params(arch)
    toks, want, want_aux, jcache = jax_run(arch)
    got, aux = transformer.forward(tp, torch.from_numpy(toks), tcfg)
    close(got, want[0])
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5)
    got, cache = transformer.prefill(tp, torch.from_numpy(toks), tcfg, 16)
    close(got, want[1])
    for i, pos in enumerate((12, 13)):
        got, cache = transformer.decode_step(
            tp, torch.from_numpy(toks[:, pos - 12:pos - 11]), pos, cache,
            tcfg)
        close(got, want[2 + i])
    assert sorted(cache) == sorted(jcache)
    for slot, entry in cache.items():
        for name, value in entry.items():
            close(value, jcache[slot][name])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_prefill_decode_logits(arch, impl):
    check_forward_prefill_decode_logits(arch, impl)


def test_reference_pallas_path_agrees():
    """The reference's own Pallas path (flash and decode attention in
    interpret mode) on Moonlight's smoke config, against the port's kernel
    path, through forward, prefill and two decode steps."""
    arch = "moonshot_v1_16b_a3b"
    jcfg, tcfg = mcfgs(arch, attn_impl="pallas")
    jp, tp = ref_params(arch)
    toks = tokens(5, 2, 10)
    want, _ = jforward(jp, jnp.asarray(toks), cfg=jcfg, mode="eval")
    got, _ = transformer.forward(tp, torch.from_numpy(toks), tcfg)
    close(got, want)
    want, jcache = jprefill(jp, jnp.asarray(toks), jcfg, 12)
    got, cache = transformer.prefill(tp, torch.from_numpy(toks), tcfg, 12)
    close(got, want)
    for pos in (10, 11):
        step = toks[:, pos - 10:pos - 9]
        want, jcache = jdecode(jp, jnp.asarray(step), jnp.int32(pos),
                               jcache, jcfg)
        got, cache = transformer.decode_step(tp, torch.from_numpy(step), pos,
                                             cache, tcfg)
        close(got, want)


def check_greedy_generate(arch):
    """Greedy generation on the kernel path equals teacher forcing through
    the full-sequence forward (dropless: the forward over prompt and new
    tokens routes at most 2 x 13 tokens a group) and the reference's
    ``generate``."""
    jcfg, tcfg = mcfgs(arch, attn_impl="pallas")
    jcfg = dataclasses.replace(jcfg, attn_impl="xla")
    jp, tp = ref_params(arch)
    prompt = tokens(0, 2, 8)
    out = sampling.generate(tp, torch.from_numpy(prompt), tcfg,
                            max_new_tokens=5)
    assert out.shape == (2, 5) and out.dtype == torch.int32
    seq = torch.from_numpy(prompt)
    for i in range(5):
        logits, _ = transformer.forward(tp, seq, tcfg)
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)
        torch.testing.assert_close(out[:, i], nxt, rtol=0, atol=0)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    want = jsampling.generate(jp, jnp.asarray(prompt), jcfg,
                              max_new_tokens=5)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_teacher_forcing_and_the_reference(arch):
    check_greedy_generate(arch)


@pytest.mark.parametrize("arch", MOE)
def test_port_init_matches_the_reference_layout(arch):
    """The MoE slots' router, fused ``w_in`` and ``w_down``, stacked over
    the periods, in bf16 params."""
    tcfg = check_init_layout(arch, **moe_changes(arch))
    assert any(s.ffn == "moe" for s in tcfg.block_pattern())


def test_init_fills_the_stack_in_draw_order():
    """``init_params`` fills each stacked tensor period by period: the
    same seed gives the same weights as drawing the periods one after
    another and stacking them."""
    from repro_torch.models import layers as L

    _, tcfg = mcfgs("moonshot_v1_16b_a3b")
    params = transformer.init_params(torch.Generator().manual_seed(3), tcfg)
    gen = torch.Generator().manual_seed(3)
    L.init_embedding(gen, tcfg.vocab_size, tcfg.d_model, torch.float32)
    slot = tcfg.block_pattern()[0]
    draws = [transformer._init_slot(gen, tcfg, slot, torch.float32)
             for _ in range(tcfg.num_periods())]
    for name in ("router", "w_in", "w_down"):
        torch.testing.assert_close(
            params["slots"]["slot0"]["moe"][name],
            torch.stack([d["moe"][name] for d in draws]), rtol=0, atol=0)


@pytest.mark.parametrize("arch", [*ARCHS, "whisper_medium"])
def test_reference_trees_convert_and_nest_back(arch):
    check_trees_convert(arch)


def check_trees_convert(arch):
    """The reference's parameter trees with MoE slots (float32, the
    weights the tests above convert) and Whisper's encoder and decoder
    stacks (bf16 params) go to the port's flat dict and nest back to the
    reference's nesting, values and dtypes kept."""
    if arch == "whisper_medium":
        jcfg = dataclasses.replace(jsmoke_config(jget_config(arch)),
                                   param_dtype="bfloat16")
        tree = jencdec.init_params(jax.random.PRNGKey(1), jcfg)
    else:
        tree = ref_params(arch)[0]
    tree = jax.tree.map(np.asarray, tree)
    flat = params_from_reference(tree)
    want = flatten_params(tree)
    assert sorted(flat) == sorted(want)
    for name, value in flatten_params(nest_params(flat)).items():
        assert str(value.dtype).replace("torch.", "") == str(want[name].dtype)
        np.testing.assert_array_equal(value.float().numpy(),
                                      want[name].astype(np.float32))
