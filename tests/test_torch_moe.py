"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe``.

The same numpy inputs go through both ``moe_block``s with the reference's
``init_moe`` weights converted by ``params_from_reference``. Configs are
Mixtral-8x22B's smoke config with the expert counts each case names.
Tolerances: float32 compute, output 1e-5 relative to the output's scale
(1e-5 relative and 1e-5 of the largest |value| absolute: the reference's
``init_moe`` scales ``w_in`` by 1/sqrt(experts), so outputs reach ~20 and
the matrix products, summed in another order, differ by ~1e-5 on elements
near zero), aux loss 1e-6 relative, ``expert_load`` exact (the same top-k
choices); bfloat16 compute 5e-2 relative to the output's scale (a few
bf16 roundings of 2^-8 relative, taken at different places by the two
frameworks). Every case also checks that the two packages drop the same
(token, choice) pairs, through the load and the output.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import nest_params, params_from_reference
from repro_torch.models import moe

# the reference's layer, compiled once per config and shape (op-by-op
# dispatch of its one-hots and gathers is slower than a compile)
jmoe_block = jax.jit(jmoe.moe_block, static_argnums=(2, 3))
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)


def cfgs(**changes):
    """Mixtral's smoke config (4 experts, top-2, d 128, expert ff 128) in
    both packages, with ``changes``."""
    changes.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(jsmoke_config(jget_config("mixtral_8x22b")),
                                **changes),
            dataclasses.replace(smoke_config(get_config("mixtral_8x22b")),
                                **changes))


def weights(jcfg, seed):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, nest_params(params_from_reference(
        jax.tree.map(np.asarray, jp)))


def inputs(seed, b, s, d, zero_rows=()):
    x = np.random.RandomState(seed).standard_normal((b, s, d)).astype(
        np.float32)
    for row in zero_rows:
        x.reshape(b * s, d)[row] = 0.0
    return x


def run_both(x, seed=0, tol=F32, **changes):
    """Both packages' moe_block on ``x``; returns the port's outputs."""
    jcfg, tcfg = cfgs(**changes)
    jp, tp = weights(jcfg, seed)
    cdt = jcfg.compute_dtype
    want = jmoe_block(jp, jnp.asarray(x).astype(cdt), jcfg, jnp.dtype(cdt))
    tx = torch.from_numpy(x).to(getattr(torch, cdt))
    got = moe.moe_block(tp, tx, tcfg, getattr(torch, cdt))
    out, aux, load = got
    assert out.shape == x.shape and out.dtype == tx.dtype
    assert aux.dtype == torch.float32 and aux.dim() == 0
    assert load.dtype == torch.int32 and load.shape == (tcfg.moe_num_experts,)
    np.testing.assert_array_equal(load.numpy(), np.asarray(want[2]))
    ref = np.asarray(want[0], np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)
    np.testing.assert_allclose(float(aux), float(want[1]), rtol=1e-6)
    return got


def test_mixtral_smoke_config():
    out, aux, load = run_both(inputs(0, 2, 16, 128))
    assert int(load.sum()) == 2 * 16 * 2
    assert float(aux) > 0


def test_64_experts_top_6():
    """Moonlight's routing (64 experts, top-6) at smoke width; 48 tokens
    are within the dropless group size, 320 are not."""
    for s in (24, 160):
        out, _, load = run_both(inputs(1, 2, s, 128), seed=1,
                                moe_num_experts=64, moe_top_k=6)
        assert int(load.sum()) == 2 * s * 6


def test_virtual_expert_split():
    """moe_ep_split 2: each expert's FFN in two half-width virtual experts
    (the reference's layout for them), through a group with drops."""
    run_both(inputs(2, 4, 128, 128), seed=2, moe_ep_split=2,
             moe_capacity_factor=1.0)


def test_capacity_drops():
    """512 tokens at capacity factor 1.0: the group's capacity is 256
    slots an expert, so the busiest experts drop their last choices."""
    jcfg, tcfg = cfgs(moe_capacity_factor=1.0)
    cap = moe.expert_capacity(512, tcfg)
    assert cap == 256
    out, _, load = run_both(inputs(3, 4, 128, 128), seed=3,
                            moe_capacity_factor=1.0)
    assert int(load.max()) > cap       # some choices were dropped


def test_padded_second_group():
    """4616 tokens: a full group of 4096 and one of 520 real tokens padded
    with 3576 zero rows, which are routed (they count in the load) and take
    slots after every real token."""
    x = inputs(4, 2, 2308, 128)
    out, _, load = run_both(x, seed=4)
    assert int(load.sum()) == 2 * 4096 * 2
    # the padded rows tie every expert: they all choose experts 0 and 1
    jcfg, tcfg = cfgs()
    _, tp = weights(jcfg, 4)
    _, _, top_i = moe.route(tp, torch.zeros((1, 3, 128)), tcfg,
                            torch.float32)
    assert top_i.tolist() == [[[0, 1]] * 3]


def test_all_zero_rows_tie_to_the_lowest_experts():
    """All-zero rows have all-zero logits: every probability ties, and
    both packages choose the lowest-indexed experts, in index order (64
    experts, top-6: experts 0-5)."""
    x = inputs(5, 2, 16, 128, zero_rows=(0, 5, 17, 31))
    run_both(x, seed=5, moe_num_experts=64, moe_top_k=6)
    jcfg, tcfg = cfgs(moe_num_experts=64, moe_top_k=6)
    _, tp = weights(jcfg, 5)
    probs, top_w, top_i = moe.route(tp, torch.zeros((1, 2, 128)), tcfg,
                                    torch.float32)
    assert top_i.tolist() == [[list(range(6))] * 2]
    np.testing.assert_allclose(top_w.numpy(), 1 / 6, rtol=1e-6)


def test_bf16_compute():
    run_both(inputs(6, 2, 16, 128), seed=6, tol=BF16,
             compute_dtype="bfloat16")


@pytest.mark.parametrize("experts,k,factor", [(4, 2, 1.25), (64, 6, 1.25),
                                              (16, 2, 1.0), (2, 2, 4.0)])
def test_expert_capacity_matches_the_reference(experts, k, factor):
    jcfg, tcfg = cfgs(moe_num_experts=experts, moe_top_k=k,
                      moe_capacity_factor=factor)
    assert moe.GROUP_SIZE == jmoe.GROUP_SIZE == 4096
    for size in range(1, 8193):
        assert moe.expert_capacity(size, tcfg) == \
            jmoe.expert_capacity(size, jcfg), size


def test_init_layout_matches_the_reference():
    jcfg, tcfg = cfgs(moe_num_experts=8, moe_top_k=2, moe_ep_split=2)
    want = jax.eval_shape(lambda: jmoe.init_moe(jax.random.PRNGKey(0), jcfg,
                                                jnp.bfloat16))
    got = moe.init_moe(torch.Generator().manual_seed(0), tcfg,
                       torch.bfloat16)
    assert sorted(got) == sorted(want)
    for name, value in got.items():
        assert tuple(value.shape) == want[name].shape
        assert value.dtype == torch.bfloat16
