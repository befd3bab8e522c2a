"""The port's train steps against ``repro.training.train_loop``: one step of
``make_train_step`` on the smoke configs of StarCoder2-3B (dense) and
Qwen2-VL-2B (M-RoPE positions from ``make_batch_for``), with remat on, in
float32 and (StarCoder2-3B) in bfloat16 compute.
``test_torch_train_step_families.py`` holds the MoE, SSM and
encoder-decoder configs with these helpers, and
``test_torch_train_checks.py`` the port's own copies of the reference's
training checks.

Weights are the reference's ``init_params`` converted with
``params_from_reference``; batches are the reference's ``make_batch_for``
(numpy). The port's step updates its trees in place.

Tolerances, float32 compute: loss, aux loss and grad norm 1e-5 relative;
``mu`` and ``nu`` (0.1 and 0.05 times the clipped gradient and its square
after one step, so they hold each gradient leaf) 5e-5 of each leaf's
largest magnitude, the gradients' sums being taken in other orders. The
parameters move by lr_0 (3e-6, the first step of the warmup) times
``mhat / (sqrt(vhat) + eps)``, which is +-1 wherever |g| >> eps and turns
on the value of g where |g| ~ eps: they are held within lr_0. bfloat16
compute (a few bf16 roundings of 2^-8 at other places in the two
frameworks, as in ``test_torch_models.py``): loss and aux 1e-3 relative,
grad norm 5e-3, ``mu`` 5e-2 and ``nu`` (a square: twice the relative
error) 1e-1 of each leaf's largest magnitude, and the parameters 2.1 lr_0:
a gradient near zero whose sign differs moves a leaf by 2 lr_0 (1 + wd |p|)
at most.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import make_batch_for
from repro.models import encdec as jencdec
from repro.models import transformer as jt
from repro.training import adamw_init as jadamw_init
from repro.training import train_loop as jloop
from repro_torch.convert import nest_params, params_from_reference
from repro_torch.training import adamw_init, train_loop
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.tree import leaves_with_names
from test_torch_models import cfgs

LR0 = AdamWConfig().lr / AdamWConfig().warmup_steps
TOL = {"float32": dict(loss=1e-5, grad_norm=1e-5, mu=5e-5, nu=5e-5,
                       params=LR0),
       "bfloat16": dict(loss=1e-3, grad_norm=5e-3, mu=5e-2, nu=1e-1,
                        params=2.1 * LR0)}


def ref_state(jcfg):
    init = jencdec.init_params if jcfg.is_encoder_decoder \
        else jt.init_params
    jp = init(jax.random.PRNGKey(0), jcfg)
    return jp, nest_params(params_from_reference(jax.tree.map(np.asarray,
                                                              jp)))


def both_steps(arch, dtype="float32", batch=2, seq=16, **changes):
    """One train step of each package from the same weights and batch:
    ((jax params, opt state, metrics), (port params, opt state, metrics))."""
    jcfg, tcfg = cfgs(arch, compute_dtype=dtype, remat=True, **changes)
    jp, tp = ref_state(jcfg)
    data = make_batch_for(jcfg, batch, seq)
    if jcfg.is_encoder_decoder:
        jstep = jloop.make_whisper_train_step(jcfg)
        tstep = train_loop.make_whisper_train_step(tcfg)
    else:
        jstep = jloop.make_train_step(jcfg)
        tstep = train_loop.make_train_step(tcfg)
    want = jax.jit(jstep)(jp, jadamw_init(jp),
                          {k: jnp.asarray(v) for k, v in data.items()})
    got = tstep(tp, adamw_init(tp),
                {k: torch.from_numpy(v) for k, v in data.items()})
    return want, got


def check_step(want, got, dtype):
    tol = TOL[dtype]
    (jp, jo, jm), (tp, to, tm) = want, got
    assert jm.keys() == tm.keys()
    for k in tm:
        assert tm[k].dtype == torch.float32 and tm[k].shape == ()
        np.testing.assert_allclose(
            float(tm[k]), float(jm[k]), atol=1e-7,
            rtol=tol["grad_norm" if k == "grad_norm" else "loss"],
            err_msg=k)
    assert int(to.step) == int(jo.step) == 1
    jleaves = jax.tree_util.tree_flatten_with_path(
        {"params": jp, "opt_state": jo})[0]
    tleaves = leaves_with_names({"params": tp, "opt_state": to})
    assert [jax.tree_util.keystr(p) for p, _ in jleaves] == \
        [n for n, _ in tleaves]
    for (_, a), (name, b) in zip(jleaves, tleaves):
        a, b = np.asarray(a, np.float32), b.float().numpy()
        assert a.shape == b.shape, name
        if name.startswith("['params']"):
            np.testing.assert_allclose(b, a, rtol=0, atol=tol["params"],
                                       err_msg=name)
        elif ".step" not in name:
            rel = tol["mu" if ".mu" in name else "nu"]
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=rel * np.abs(a).max(),
                                       err_msg=name)


@pytest.mark.parametrize("arch", ["starcoder2_3b", "qwen2_vl_2b"])
def test_train_step_matches_the_reference(arch):
    check_step(*both_steps(arch), "float32")


def test_train_step_matches_the_reference_in_bfloat16():
    check_step(*both_steps("starcoder2_3b", "bfloat16"), "bfloat16")
