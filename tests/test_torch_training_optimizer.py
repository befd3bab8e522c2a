"""The port's AdamW, int8 error-feedback compression and loss against
``repro.training``, and its copy of the data pipeline.

Inputs are trees of float32 arrays from numpy seeds, fed to both packages:
the same parameters and, at each of three steps, the same gradients.
Tolerances: AdamW's grad norm 1e-6 relative, and its params and moments
1e-6 relative to each leaf's largest magnitude (float32, the same
operations in the same order, a rounding or two apart, fused or not; the
moment update ``b1 * m + (1 - b1) * g`` cancels where m and g differ in
sign, so an element near zero carries the roundings of operands ~1e3 times
its size); a bfloat16 parameter one bfloat16 rounding (2^-8 relative). The
compressed gradients and residuals agree within one quantum of their leaf
(max|g| / 127) and are equal except where the reference's input sits at a
tie of the rounding (a half-integer multiple of the quantum, within 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipeline
from repro.training import compression as jcomp
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch.data import pipeline as tpipeline
from repro_torch.training import compression as tcomp
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop
from repro_torch.training.tree import leaves, leaves_with_names

SHAPES = {"embed": {"table": (64, 16)},
          "slots": {"slot0": {"attn": {"wq": (3, 16, 16), "wo": (3, 16, 16)},
                              "norm1": {"scale": (3, 16)}}},
          "final_norm": {"scale": (16,)}}


def arrays(seed, scale=1.0, shapes=SHAPES):
    """A tree of ``shapes``' nesting holding float32 normals from ``seed``
    times ``scale``."""
    rng = np.random.RandomState(seed)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else
                (rng.standard_normal(v) * scale).astype(np.float32)
                for k, v in tree.items()}

    return fill(shapes)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def assert_tree_close(got, want, rel):
    """Each leaf within ``rel`` of the largest magnitude of its leaf."""
    names = [n for n, _ in leaves_with_names(got)]
    want_leaves = [np.asarray(w, np.float32)
                   for w in jax.tree_util.tree_leaves(want)]
    assert len(names) == len(want_leaves)
    for name, g, w in zip(names, leaves(got), want_leaves):
        np.testing.assert_allclose(g.float().numpy(), w, rtol=rel,
                                   atol=rel * np.abs(w).max(), err_msg=name)


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #

CASES = {
    # (config, gradient scale): the global norm of the grads is ~28 x scale
    "clipping": (dict(grad_clip=1.0, warmup_steps=100), 1.0),
    "no_clipping": (dict(grad_clip=1.0, warmup_steps=100), 1e-3),
    "clip_off": (dict(grad_clip=0.0, warmup_steps=100), 1.0),
    "warmup_2_steps": (dict(grad_clip=1.0, warmup_steps=2, lr=1e-2), 0.3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_adamw_three_steps_match_the_reference(case):
    changes, gscale = CASES[case]
    params = arrays(0, 0.1)
    jp, tp = to_jax(params), to_torch(params)
    jo, to = jopt.adamw_init(jp), topt.adamw_init(tp)
    jcfg = jopt.AdamWConfig(**changes)
    tcfg = topt.AdamWConfig(**changes)
    for step in range(3):
        grads = arrays(10 + step, gscale)
        jp, jo, jn = jopt.adamw_update(to_jax(grads), jo, jp, jcfg)
        tp_out, to, tn = topt.adamw_update(to_torch(grads), to, tp, tcfg)
        assert tp_out is tp                      # updated in place
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert int(to.step) == int(jo.step) == step + 1
        assert to.step.dtype == torch.int32
        assert_tree_close(tp, jp, 1e-6)
        assert_tree_close(to.mu, jo.mu, 1e-6)
        assert_tree_close(to.nu, jo.nu, 1e-6)
    if case == "clipping":
        assert float(tn) > tcfg.grad_clip


def test_adamw_updates_leaves_larger_than_one_chunk(monkeypatch):
    """A leaf is updated in slices of UPDATE_CHUNK elements: with chunks of
    100 (a ragged last slice on every leaf) the result is the same."""
    params, grads = arrays(0, 0.1), arrays(1)
    out = []
    for chunk in (topt.UPDATE_CHUNK, 100):
        monkeypatch.setattr(topt, "UPDATE_CHUNK", chunk)
        tp = to_torch(params)
        topt.adamw_update(to_torch(grads), topt.adamw_init(tp), tp)
        out.append(tp)
    for a, b in zip(leaves(out[0]), leaves(out[1])):
        assert torch.equal(a, b)


def test_global_norm_of_large_leaves_matches_float64():
    """The norm over leaves of 2^24 and 2^22 elements, against a float64
    sum: within 1e-6 (a float32 accumulation along the leaf, as
    ``torch.linalg.vector_norm`` runs it, is 4e-4 off here)."""
    gen = torch.Generator().manual_seed(0)
    grads = {"a": torch.randn(1 << 24, generator=gen) * 1e-3,
             "b": {"c": torch.randn(1 << 11, 1 << 11, generator=gen)}}
    grads["a"][::97] += 0.5
    exact = sum(float((g.double() ** 2).sum()) for g in leaves(grads)) ** 0.5
    got = topt.global_norm(grads)
    assert got.dtype == torch.float32
    assert abs(float(got) / exact - 1) < 1e-6


def test_adamw_bfloat16_params_round_once():
    shapes = {"w": (32, 16)}
    params, grads = arrays(0, 0.1, shapes), arrays(1, 1.0, shapes)
    jp = {"w": jnp.asarray(params["w"]).astype(jnp.bfloat16)}
    tp = {"w": torch.from_numpy(params["w"]).to(torch.bfloat16)}
    jp, jo, _ = jopt.adamw_update(to_jax(grads), jopt.adamw_init(jp), jp)
    topt.adamw_update(to_torch(grads), topt.adamw_init(tp), tp)
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(tp["w"].float().numpy(),
                               np.asarray(jp["w"], np.float32),
                               rtol=2 ** -8, atol=0)


# --------------------------------------------------------------------------- #
# int8 error-feedback compression
# --------------------------------------------------------------------------- #

def test_compression_three_steps_match_the_reference():
    params = arrays(0)
    jr, tr = jcomp.ef_init(to_jax(params)), tcomp.ef_init(to_torch(params))
    for step in range(3):
        grads = arrays(20 + step, 1e-2)
        # the reference's input to the quantiser, to tell ties
        jin = jax.tree.map(lambda g, r: np.asarray(g, np.float32)
                           + np.asarray(r), grads, jr)
        jg, jr = jcomp.compress_grads(to_jax(grads), jr)
        tg, tr = tcomp.compress_grads(to_torch(grads), tr)
        for name, g_in, a, b, ra, rb in zip(
                [n for n, _ in leaves_with_names(tg)], leaves(jin),
                jax.tree_util.tree_leaves(jg), leaves(tg),
                jax.tree_util.tree_leaves(jr), leaves(tr)):
            quantum = np.abs(g_in).max() / 127.0 + 1e-12
            a, ra = np.asarray(a), np.asarray(ra)
            b, rb = b.numpy(), rb.numpy()
            assert b.dtype == rb.dtype == np.float32
            assert np.abs(a - b).max() <= quantum * (1 + 1e-6), name
            assert np.abs(ra - rb).max() <= quantum * (1 + 1e-6), name
            frac = np.abs(g_in / quantum) % 1.0
            differ = (a != b) | (ra != rb)
            assert np.all(np.abs(frac[differ] - 0.5) < 1e-4), name
            # the residual is what the quantiser lost
            np.testing.assert_allclose(b + rb, g_in, rtol=0, atol=1e-6)


def test_compressed_bytes_and_int8_range():
    grads = arrays(3)
    assert tcomp.compressed_bytes(to_torch(grads)) == \
        jcomp.compressed_bytes(to_jax(grads)) == \
        sum(a.size + 4 for a in jax.tree_util.tree_leaves(grads))
    g = torch.from_numpy(grads["embed"]["table"])
    q = tcomp._quant_dequant(g)
    scale = g.abs().max() / 127.0 + 1e-12
    assert torch.all((q / scale).round().abs() <= 127)


# --------------------------------------------------------------------------- #
# loss and data
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("logical_vocab", [0, 60])
def test_cross_entropy_loss_matches_the_reference(logical_vocab):
    rng = np.random.RandomState(4)
    logits = (rng.standard_normal((2, 5, 64)) * 3).astype(np.float32)
    if logical_vocab:
        logits[..., logical_vocab:] = -1e30
    labels = rng.randint(0, logical_vocab or 64, (2, 5)).astype(np.int32)
    want = jloop.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                    logical_vocab)
    got = tloop.cross_entropy_loss(torch.from_numpy(logits),
                                   torch.from_numpy(labels), logical_vocab)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    bf = tloop.cross_entropy_loss(torch.from_numpy(logits).bfloat16(),
                                  torch.from_numpy(labels))
    assert bf.dtype == torch.float32


def test_data_pipeline_copy_gives_the_reference_batches():
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config

    for arch in ("starcoder2_3b", "whisper_medium", "qwen2_vl_2b"):
        a = jpipeline.make_batch_for(jget_config(arch), 2, 16, step=3)
        b = tpipeline.make_batch_for(get_config(arch), 2, 16, step=3)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    ds_a = jpipeline.SyntheticLMDataset(512, 32, 8, seed=1, branching=2)
    ds_b = tpipeline.SyntheticLMDataset(512, 32, 8, seed=1, branching=2)
    for step in (0, 7):
        for k, v in ds_a.batch(step).items():
            np.testing.assert_array_equal(ds_b.batch(step)[k], v)
