"""The port's Mamba-1 block (``repro_torch.models.ssm``) against
``repro.models.ssm``, function by function, at Falcon-Mamba's smoke width
(d_model 128, d_inner 256, state 8, conv width 4, dt_rank 256).

Weights are the reference's ``init_mamba`` converted with
``params_from_reference``; activations and states come from numpy seeds.
Tolerances: float32 1e-5 (the same float32 math, sums in another order);
bfloat16 2e-2 on values of magnitude ~1 (the two frameworks round bf16 at
different places: XLA may keep a fused chain in float32 where torch rounds
after every operation).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.models import ssm

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the reference's block, compiled once per shape (its eager scans would
# compile at every call)
jforward = jax.jit(jssm.mamba_forward, static_argnums=(2, 3))
jdecode = jax.jit(jssm.mamba_decode_step, static_argnums=(3, 4))


def cfgs(**changes):
    return (dataclasses.replace(jsmoke_config(jget_config("falcon_mamba_7b")),
                                **changes),
            dataclasses.replace(smoke_config(get_config("falcon_mamba_7b")),
                                **changes))


_PARAMS = {}


def params(dtype):
    """The reference's weights of one mamba layer in ``dtype``, and their
    conversion."""
    if dtype not in _PARAMS:
        jcfg, _ = cfgs()
        jp = jssm.init_mamba(jax.random.PRNGKey(0), jcfg,
                             getattr(jnp, dtype))
        _PARAMS[dtype] = jp, params_from_reference(
            jax.tree.map(np.asarray, jp))
    return _PARAMS[dtype]


def draw(seed, shape, dtype="float32", scale=1.0):
    """The same numbers as a JAX array and a torch tensor in ``dtype``."""
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(TORCH_DTYPES[dtype]))


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_layout_and_fixed_draws_match_the_reference(dtype):
    """Names, shapes and dtypes are the reference's; A_log, D, conv_b and
    the dt bias (numpy's RandomState(0)) are equal bit for bit."""
    _, tcfg = cfgs()
    jp, converted = params(dtype)
    mine = ssm.init_mamba(torch.Generator().manual_seed(0), tcfg,
                          TORCH_DTYPES[dtype])
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in converted.items()}
    for name in ("A_log", "D", "conv_b", "dt_bias"):
        torch.testing.assert_close(mine[name], converted[name], rtol=0,
                                   atol=0)
    assert mine["A_log"].dtype == mine["D"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_history", [False, True])
def test_causal_conv(dtype, with_history):
    jp, p = params(dtype)
    jx, tx = draw(1, (2, 9, 256), dtype)
    jh, th = draw(2, (2, 3, 256), dtype) if with_history else (None, None)
    want = jssm._causal_conv(jx, jp["conv_w"], jp["conv_b"], jh)
    got = ssm._causal_conv(tx, p["conv_w"], p["conv_b"], th)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (2, 9, 256)
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_inputs(dtype):
    jcfg, tcfg = cfgs()
    jp, p = params(dtype)
    jx, tx = draw(3, (2, 7, 256), dtype)
    want = jssm._ssm_inputs(jp, jx, jcfg, getattr(jnp, dtype))
    got = ssm._ssm_inputs(p, tx, tcfg, TORCH_DTYPES[dtype])
    for g, w, n in zip(got, want, (256, 8, 8)):
        assert g.dtype == torch.float32 and g.shape == (2, 7, n)
        close(g, w, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mamba_forward_on_both_paths(impl, dtype):
    """Without a state: the port's kernel path ("pallas": on the CPU the
    kernel's plain version) and its plain scan against the reference's
    chunked associative scan (block 32 over 40 steps: a partial chunk),
    output and final state."""
    jcfg, tcfg = cfgs(attn_impl=impl)
    jcfg = dataclasses.replace(jcfg, attn_impl="xla")
    jp, p = params(dtype)
    jx, tx = draw(4, (2, 40, 128), dtype)
    cdt = getattr(jnp, dtype)
    want, jstate = jforward(jp, jx, jcfg, cdt)
    got, state = ssm.mamba_forward(p, tx, tcfg, TORCH_DTYPES[dtype])
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (2, 40, 128)
    close(got, want, TOL[dtype])
    close(state["conv"], jstate["conv"], TOL[dtype])
    assert state["ssm"].dtype == torch.float32
    close(state["ssm"], jstate["ssm"], TOL[dtype])


def test_reference_kernel_path_agrees():
    """The reference's own Pallas path (``mamba_scan`` in interpret mode)
    against the port's kernel path, float32."""
    jcfg, tcfg = cfgs(attn_impl="pallas")
    jp, p = params("float32")
    jx, tx = draw(5, (1, 24, 128))
    want, jstate = jforward(jp, jx, jcfg, jnp.float32)
    got, state = ssm.mamba_forward(p, tx, tcfg, torch.float32)
    close(got, want, TOL["float32"])
    close(state["ssm"], jstate["ssm"], TOL["float32"])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mamba_forward_continues_a_state(impl):
    """With a state both packages take the plain scan (the kernel path
    needs state None), also for S > 1."""
    jcfg, tcfg = cfgs(attn_impl=impl)
    jcfg = dataclasses.replace(jcfg, attn_impl="xla")
    jp, p = params("float32")
    jx, tx = draw(6, (2, 5, 128))
    jconv, tconv = draw(7, (2, 3, 256))
    jh, th = draw(8, (2, 256, 8), scale=0.5)
    want, jstate = jforward(jp, jx, jcfg, jnp.float32,
                            {"conv": jconv, "ssm": jh})
    got, state = ssm.mamba_forward(p, tx, tcfg, torch.float32,
                                   state={"conv": tconv, "ssm": th})
    close(got, want, TOL["float32"])
    close(state["conv"], jstate["conv"], TOL["float32"])
    close(state["ssm"], jstate["ssm"], TOL["float32"])


@pytest.mark.parametrize("s", [1, 2, 3, 7])
@pytest.mark.parametrize("with_history", [False, True])
def test_conv_tail(s, with_history):
    """The last W-1 = 3 inputs: padded in front when S < 3 without
    history, taken across history and the new inputs with it."""
    jx, tx = draw(9 + s, (2, s, 16))
    jh, th = draw(20, (2, 3, 16)) if with_history else (None, None)
    want = jssm._conv_tail(jx, 4, jh)
    got = ssm._conv_tail(tx, 4, th)
    assert got.shape == (2, 3, 16)
    close(got, want, dict(rtol=0, atol=0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_after_a_prefill(dtype):
    """A prefill's state, then four single-token steps, each output and
    state against the reference's."""
    jcfg, tcfg = cfgs(attn_impl="pallas")
    jcfg = dataclasses.replace(jcfg, attn_impl="xla")
    jp, p = params(dtype)
    cdt, tdt = getattr(jnp, dtype), TORCH_DTYPES[dtype]
    jx, tx = draw(30, (2, 10, 128), dtype)
    _, jstate = jforward(jp, jx, jcfg, cdt)
    _, state = ssm.mamba_forward(p, tx, tcfg, tdt)
    for i in range(4):
        jt, tt = draw(31 + i, (2, 1, 128), dtype)
        want, jstate = jdecode(jp, jt, jstate, jcfg, cdt)
        got, state = ssm.mamba_decode_step(p, tt, state, tcfg, tdt)
        assert got.shape == (2, 1, 128)
        close(got, want, TOL[dtype])
        close(state["ssm"], jstate["ssm"], TOL[dtype])
        close(state["conv"], jstate["conv"], TOL[dtype])


def test_init_mamba_state():
    jcfg, tcfg = cfgs()
    want = jssm.init_mamba_state(3, jcfg)
    got = ssm.init_mamba_state(3, tcfg)
    for name in ("conv", "ssm"):
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).replace("torch.", "") == \
            str(want[name].dtype)
        assert not got[name].any()
