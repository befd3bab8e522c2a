"""The port's generation loop, sampling, configs and parameter layout
against ``repro.models`` and ``repro.configs``.

Weights are the reference's ``init_params`` converted with
``params_from_reference`` (float32 compute); greedy tokens must be equal.
The helpers are those of ``test_torch_models.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.models import sampling as jsampling
from repro.models import transformer as jt
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.convert import flatten_params, nest_params
from repro_torch.models import kvcache, sampling, transformer
from test_torch_models import DENSE, SSM, cfgs, ref_params, tokens


# the port's switches that the reference's ModelConfig lacks (Jamba2-Mini's:
# held experts, the dropless layer, the top-k weights as they are, attention
# without RoPE, the mixer's norms), each at the default under which the port
# computes what the reference computes
PORT_ONLY = {"moe_experts_held": 0, "moe_dropless": False,
             "moe_renormalize": True, "attn_rope": True,
             "ssm_dt_bc_norms": False}


def reference_fields(cfg) -> dict:
    """``cfg``'s fields but the port's own, which must be at their
    defaults."""
    d = dataclasses.asdict(cfg)
    assert {k: d.pop(k) for k in PORT_ONLY} == PORT_ONLY
    return d


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_copies_match_the_reference_field_for_field(arch):
    assert reference_fields(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    assert reference_fields(smoke_config(get_config(arch))) == \
        dataclasses.asdict(jsmoke_config(jget_config(arch)))


def test_greedy_generate_matches_teacher_forcing_and_the_reference():
    jcfg, tcfg = cfgs("starcoder2_3b", attn_impl="pallas")
    jcfg = dataclasses.replace(jcfg, attn_impl="xla")
    jp, tp = ref_params("starcoder2_3b")
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
    want = jsampling.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=5)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_generation_ring_wraps_under_a_sliding_window():
    jcfg, tcfg = cfgs("starcoder2_3b", sliding_window=12, attn_impl="pallas")
    jcfg = dataclasses.replace(jcfg, attn_impl="xla")
    jp, tp = ref_params("starcoder2_3b")
    prompt = tokens(1, 1, 10)
    out = sampling.generate(tp, torch.from_numpy(prompt), tcfg,
                            max_new_tokens=8, cache_width=12)
    want = jsampling.generate(jp, jnp.asarray(prompt), jcfg,
                              max_new_tokens=8, cache_width=12)
    assert out.shape == (1, 8) and (out >= 0).all()
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_temperature_sampling_respects_top_k():
    logits = torch.tensor([[0.0, 10.0, 9.0, -5.0]])
    gen = torch.Generator().manual_seed(0)
    seen = {int(sampling.sample_token(logits, gen, temperature=1.0,
                                      top_k=2)[0]) for _ in range(20)}
    assert seen == {1, 2}
    assert int(sampling.sample_token(logits)[0]) == 1


@pytest.mark.parametrize("arch", ["whisper_medium"])
def test_transformer_does_not_build_encoder_decoder_models(arch):
    """The decoder-only stack refuses an encoder-decoder config, as the
    reference's does not build it either; the error names the module that
    does (every other family, MoE included, is built)."""
    cfg = smoke_config(get_config(arch))
    with pytest.raises(NotImplementedError, match="models/encdec.py"):
        transformer.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(NotImplementedError, match="models/encdec.py"):
        transformer.forward({}, torch.zeros((1, 4), dtype=torch.int32), cfg)


def check_init_layout(arch, **changes):
    """The port's own init gives the reference's names, shapes and dtypes,
    and flatten/nest carry it to the store's flat dict and back."""
    jcfg, tcfg = cfgs(arch, param_dtype="bfloat16", **changes)
    want = flatten_params(jax.tree.map(
        lambda a: (a.shape, str(a.dtype)),
        jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0),
                                              jcfg))))
    params = transformer.init_params(torch.Generator().manual_seed(0), tcfg)
    flat = flatten_params(params)
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flat.items()}
    assert got == want
    assert flatten_params(nest_params(flat)) == flat
    return tcfg


def test_port_init_matches_the_reference_layout():
    for arch in DENSE:
        tcfg = check_init_layout(arch)
    assert kvcache.cache_width(tcfg, 100) == 100
    assert kvcache.cache_width(dataclasses.replace(tcfg, sliding_window=32),
                               100) == 32


@pytest.mark.parametrize("arch", SSM)
def test_port_init_matches_the_reference_layout_ssm(arch):
    """Falcon-Mamba's mamba slots and jamba's (MoE off) mixed period, in
    bf16 params: A_log and D stay float32, as the reference keeps them."""
    check_init_layout(arch)
