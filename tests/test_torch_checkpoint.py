"""Checkpoints that both packages read: ``repro_torch.training.checkpoint``
against ``repro.training.checkpoint``.

Each package writes ``step_<N>/shard_host0.npz`` + ``manifest.json`` with
the leaves of ``{"params", "opt_state"}`` in ``jax.tree_util``'s order,
named by their ``keystr`` paths, and restores by position. So a JAX
checkpoint restores in the port, and a port checkpoint in JAX, bit for bit,
and the two packages write equal manifests and arrays for the same state.
Also: a stale ``.tmp`` directory is invisible, the async checkpointer's
snapshot is taken before ``save`` returns (the port updates its params in
place), and ``launch.train --device cpu --preset smoke`` resumes from its
own checkpoint and from the reference's.
"""
import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.launch import train as jtrain
from repro.models import transformer as jt
from repro.training import adamw_init as jadamw_init
from repro.training import checkpoint as jckpt
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import nest_params, params_from_reference
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer
from repro_torch.training import adamw_init
from repro_torch.training import checkpoint as tckpt
from repro_torch.training.tree import leaves, leaves_with_names, tree_map

ARCH = "starcoder2_3b"


def jax_state():
    """The reference's smoke params and an opt state with nonzero moments
    and step."""
    cfg = jsmoke_config(jget_config(ARCH))
    params = jt.init_params(jax.random.PRNGKey(0), cfg)
    opt = jadamw_init(params)
    opt = opt._replace(step=jnp.asarray(5, jnp.int32),
                       mu=jax.tree.map(lambda p: p * 0.5, params),
                       nu=jax.tree.map(lambda p: p * p, params))
    return params, opt


def port_state(seed=1):
    cfg = smoke_config(get_config(ARCH))
    params = transformer.init_params(torch.Generator().manual_seed(seed), cfg)
    opt = adamw_init(params)
    opt = opt._replace(step=torch.tensor(7, dtype=torch.int32),
                       mu=tree_map(lambda p: p * 0.5, params),
                       nu=tree_map(lambda p: p * p, params))
    return params, opt


def to_port(params, opt):
    conv = lambda t: nest_params(params_from_reference(
        jax.tree.map(np.asarray, t)))
    return conv(params), opt._replace(
        step=torch.tensor(int(opt.step), dtype=torch.int32),
        mu=conv(opt.mu), nu=conv(opt.nu))


def read(path):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "shard_host0.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return manifest, arrays


def assert_bitwise(got_leaves, want_leaves):
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jp, jo = jax_state()
    jckpt.save_checkpoint(str(tmp_path), 12, jp, jo, extra={"lr": 3e-4})
    like_p, like_o = port_state(seed=2)
    step, tp, to, extra = tckpt.restore_latest(str(tmp_path), like_p,
                                               like_o)
    assert step == 12 and extra == {"lr": 3e-4}
    assert to.step.dtype == torch.int32 and int(to.step) == 5
    assert_bitwise([t.numpy() for t in leaves({"params": tp,
                                               "opt_state": to})],
                   jax.tree_util.tree_leaves({"params": jp,
                                              "opt_state": jo}))


def test_port_checkpoint_restores_in_jax(tmp_path):
    tp, to = port_state()
    tckpt.save_checkpoint(str(tmp_path), 9, tp, to, extra={"seed": 1})
    jp_like, jo_like = jax_state()
    step, jp, jo, extra = jckpt.restore_latest(str(tmp_path), jp_like,
                                               jo_like)
    assert step == 9 and extra == {"seed": 1}
    assert int(jo.step) == 7 and jo.step.dtype == jnp.int32
    assert_bitwise(jax.tree_util.tree_leaves({"params": jp,
                                              "opt_state": jo}),
                   [t.numpy() for t in leaves({"params": tp,
                                               "opt_state": to})])


def test_both_packages_write_the_same_checkpoint(tmp_path):
    jp, jo = jax_state()
    tp, to = to_port(jp, jo)
    a = jckpt.save_checkpoint(str(tmp_path / "jax"), 3, jp, jo,
                              extra={"k": 1})
    b = tckpt.save_checkpoint(str(tmp_path / "port"), 3, tp, to,
                              extra={"k": 1})
    (ma, xa), (mb, xb) = read(a), read(b)
    assert ma == mb
    assert [leaf["name"] for leaf in mb["leaves"]][:2] == [
        "['opt_state'].step", "['opt_state'].mu['embed']['table']"]
    assert xa.keys() == xb.keys()
    for k in xa:
        assert xa[k].dtype == xb[k].dtype
        np.testing.assert_array_equal(xa[k], xb[k])
    assert [n for n, _ in leaves_with_names({"params": tp,
                                             "opt_state": to})] == \
        [leaf["name"] for leaf in ma["leaves"]]


def test_bfloat16_leaves_keep_their_bits(tmp_path):
    tp, to = port_state()
    tp = tree_map(lambda t: t.to(torch.bfloat16), tp)
    path = tckpt.save_checkpoint(str(tmp_path), 1, tp, to)
    manifest, _ = read(path)
    assert {leaf["dtype"] for leaf in manifest["leaves"]} == {
        "int32", "float32", "bfloat16"}
    _, rp, _, _ = tckpt.restore_latest(str(tmp_path), tp, to)
    for a, b in zip(leaves(rp), leaves(tp)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_restore_latest_picks_newest_and_ignores_partial_write(tmp_path):
    tp, to = port_state()
    for step in (3, 12, 8):
        tckpt.save_checkpoint(str(tmp_path), step, tp, to)
    # a crash mid-write leaves a .tmp directory: never restored
    os.makedirs(tmp_path / "step_00000099.tmp")
    (tmp_path / "step_00000099.tmp" / "garbage").write_text("x")
    step, *_ = tckpt.restore_latest(str(tmp_path), tp, to)
    assert step == 12
    assert tckpt.restore_latest(str(tmp_path / "none"), tp, to) is None


def test_async_checkpointer_snapshots_before_save_returns(tmp_path):
    tp, to = port_state()
    want = [t.clone() for t in leaves(tp)]
    ck = tckpt.AsyncCheckpointer(str(tmp_path))
    ck.save(4, tp, to)
    for t in leaves(tp):            # the next step updates in place
        t.add_(1.0)
    ck.wait()
    assert ck.last_committed.endswith("step_00000004")
    _, rp, ro, _ = tckpt.restore_latest(str(tmp_path), tp, to)
    for a, b in zip(leaves(rp), want):
        assert torch.equal(a, b)
    assert int(ro.step) == 7


def run_quiet(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        history = main(argv)
    return history, out.getvalue()


def test_train_driver_resumes_from_either_package(tmp_path):
    common = ["--preset", "smoke", "--batch", "2", "--seq", "16",
              "--ckpt-every", "2", "--log-every", "1"]
    own = ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"]
    _, log = run_quiet(ttrain.main, common + own + ["--steps", "4"])
    assert "[train] starcoder2_3b preset=smoke" in log
    history, log = run_quiet(ttrain.main,
                             common + own + ["--steps", "6", "--resume"])
    assert "[train] resumed from step 4" in log
    assert [h["step"] for h in history] == [5, 6]
    # the reference's driver writes, the port's resumes
    ref_dir = ["--ckpt-dir", str(tmp_path / "jax")]
    run_quiet(jtrain.main, common + ref_dir + ["--steps", "2"])
    history, log = run_quiet(ttrain.main, common + ref_dir + [
        "--device", "cpu", "--steps", "3", "--resume"])
    assert "[train] resumed from step 2" in log
    assert np.isfinite([h["loss"] for h in history]).all()
