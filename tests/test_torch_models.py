"""The port's transformer stack against ``repro.models``.

Weights are the reference's ``init_params`` converted with
``params_from_reference``; tokens come from numpy seeds. Smoke configs of
starcoder2-3b (LayerNorm, GELU, tied), phi4-mini (RMSNorm, SwiGLU),
minitron-4b and qwen2-vl (M-RoPE), for the port's ``attn_impl`` "xla" and
"pallas" (on the CPU the latter takes the kernels' plain versions). The
reference runs its XLA path; one case also runs its Pallas path (interpret
mode). The SSM and hybrid families are held in
``test_torch_ssm_models.py`` with these helpers. Tolerances: float32
compute 1e-5 (sums in another order); bfloat16 compute 5e-2 on logits of
magnitude ~1 (a few bf16 roundings of 2^-8 relative each, taken at
different places by the two frameworks' matmuls).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.models import transformer as jt
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import nest_params, params_from_reference
from repro_torch.models import transformer

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
DENSE = ["starcoder2_3b", "phi4_mini_3_8b", "minitron_4b", "qwen2_vl_2b"]
SSM = ["falcon_mamba_7b", "jamba_v0_1_52b"]
# jamba's hybrid period without its MoE layers: the SSM and hybrid files
# hold its mamba and attention slots on their own (with its MoE layers it
# is held in test_torch_moe_models.py)
ARCH_CHANGES = {"jamba_v0_1_52b": dict(moe_num_experts=0)}

_REF = {}


def cfgs(arch, **changes):
    changes = {**ARCH_CHANGES.get(arch, {}), **changes}
    changes.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(jsmoke_config(jget_config(arch)), **changes),
            dataclasses.replace(smoke_config(get_config(arch)), **changes))


def ref_params(arch):
    """The reference's weights for ``arch`` (float32), converted once."""
    if arch not in _REF:
        jcfg, _ = cfgs(arch)
        jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
        tree = jax.tree.map(np.asarray, jp)
        _REF[arch] = jp, nest_params(params_from_reference(tree))
    return _REF[arch]


def tokens(seed, b, s):
    return np.random.RandomState(seed).randint(0, 500, (b, s)).astype(np.int32)


def close(got, want, tol=F32):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


_JAX_RUN = {}


def jax_run(arch):
    """The reference's forward, prefill and two decode steps on ``arch``
    (computed once: both of the port's paths are held against it)."""
    if arch not in _JAX_RUN:
        jcfg, _ = cfgs(arch, attn_impl="xla")
        jp, _ = ref_params(arch)
        toks = tokens(1, 2, 12)
        logits = [jt.forward(jp, jnp.asarray(toks), jcfg, mode="eval")[0]]
        out, cache = jt.prefill(jp, jnp.asarray(toks), jcfg, 16)
        logits.append(out)
        for pos in (12, 13):
            out, cache = jt.decode_step(jp, jnp.asarray(toks[:, pos - 12:
                                                             pos - 11]),
                                        pos, cache, jcfg)
            logits.append(out)
        _JAX_RUN[arch] = toks, logits, cache
    return _JAX_RUN[arch]


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_prefill_decode_logits(arch, impl):
    _, tcfg = cfgs(arch, attn_impl=impl)
    _, tp = ref_params(arch)
    toks, want, jcache = jax_run(arch)
    got, aux = transformer.forward(tp, torch.from_numpy(toks), tcfg)
    close(got, want[0])
    assert float(aux) == 0.0
    got, cache = transformer.prefill(tp, torch.from_numpy(toks), tcfg, 16)
    close(got, want[1])
    for i, pos in enumerate((12, 13)):
        got, cache = transformer.decode_step(
            tp, torch.from_numpy(toks[:, pos - 12:pos - 11]), pos, cache,
            tcfg)
        close(got, want[2 + i])
    for name in ("k", "v"):
        close(cache["slot0"][name], jcache["slot0"][name])


def test_reference_pallas_path_agrees():
    """The reference's own Pallas path (interpret mode) against the port's
    kernels' plain versions, through prefill and one decode step."""
    jcfg, tcfg = cfgs("starcoder2_3b", attn_impl="pallas")
    jp, tp = ref_params("starcoder2_3b")
    toks = tokens(2, 2, 10)
    want, jcache = jt.prefill(jp, jnp.asarray(toks), jcfg, 12)
    got, cache = transformer.prefill(tp, torch.from_numpy(toks), tcfg, 12)
    close(got, want)
    want, _ = jt.decode_step(jp, jnp.asarray(toks[:, :1]), 10, jcache, jcfg)
    got, _ = transformer.decode_step(tp, torch.from_numpy(toks[:, :1]), 10,
                                     cache, tcfg)
    close(got, want)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bf16_compute(impl):
    jcfg, tcfg = cfgs("phi4_mini_3_8b", compute_dtype="bfloat16",
                      attn_impl=impl)
    jcfg = dataclasses.replace(jcfg, attn_impl="xla")
    jp, tp = ref_params("phi4_mini_3_8b")
    toks = tokens(3, 2, 12)
    want, _ = jt.forward(jp, jnp.asarray(toks), jcfg, mode="eval")
    got, _ = transformer.forward(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.bfloat16
    close(got, want, BF16)
    want, jcache = jt.prefill(jp, jnp.asarray(toks), jcfg, 16)
    got, cache = transformer.prefill(tp, torch.from_numpy(toks), tcfg, 16)
    assert cache["slot0"]["k"].dtype == torch.bfloat16
    close(got, want, BF16)
    want, _ = jt.decode_step(jp, jnp.asarray(toks[:, :1]), 12, jcache, jcfg)
    got, _ = transformer.decode_step(tp, torch.from_numpy(toks[:, :1]), 12,
                                     cache, tcfg)
    close(got, want, BF16)


@pytest.mark.parametrize("s,width", [(6, 16), (16, 16), (21, 8)])
def test_ring_cache_after_prefill(s, width):
    """S < W pads the ring; S >= W keeps the last W positions, position j
    at slot j % W."""
    jcfg, tcfg = cfgs("minitron_4b")
    jp, tp = ref_params("minitron_4b")
    toks = tokens(4, 2, s)
    _, jcache = jt.prefill(jp, jnp.asarray(toks), jcfg, width)
    _, cache = transformer.prefill(tp, torch.from_numpy(toks), tcfg, width)
    for name in ("k", "v"):
        got = cache["slot0"][name]
        assert got.shape == (tcfg.num_periods(), 2, tcfg.num_kv_heads,
                             width, 32)
        close(got, jcache["slot0"][name])
    if s < width:
        assert (cache["slot0"]["k"][:, :, :, s:] == 0).all()
