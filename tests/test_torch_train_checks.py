"""The port's own copies of the reference's training checks
(``tests/test_training.py``), on the port alone: gradient accumulation
gives the full-batch step and refuses an indivisible batch, the loss falls
over 30 steps, rematerialisation changes no gradient, and a config with
``attn_impl="pallas"`` refuses to train (the kernels have no backward).
Tolerances are the reference's: accumulation 1e-5 on the loss and 5e-4 on
the parameters (the mean gradient summed in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data import make_batch_for
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models import encdec, transformer
from repro_torch.training import adamw_init, train_loop
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import (init_train_state,
                                             make_train_step,
                                             make_whisper_train_step)
from repro_torch.training.tree import leaves, tree_map


def tiny(arch="starcoder2_3b", **changes):
    cfg = dataclasses.replace(smoke_config(get_config(arch)), **changes)
    params, _ = init_train_state(torch.Generator().manual_seed(0), cfg)
    return cfg, params


def clone(tree):
    return tree_map(torch.clone, tree)


def as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_grad_accum_matches_full_batch():
    """accum_steps=4 must produce the same update as the full-batch step
    (same mean gradient, accumulated in float32)."""
    cfg, params = tiny(remat=False)
    batch = as_torch(make_batch_for(cfg, 8, 16))
    p1, _, m1 = make_train_step(cfg)(clone(params), adamw_init(params), batch)
    p2, _, m2 = make_train_step(cfg, accum_steps=4)(
        clone(params), adamw_init(params), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(leaves(p1), leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4,
                                   atol=5e-4)


def test_grad_accum_rejects_indivisible():
    cfg, params = tiny(remat=False)
    batch = as_torch(make_batch_for(cfg, 6, 16))
    step = make_train_step(cfg, accum_steps=4)
    with pytest.raises(ValueError, match="not divisible"):
        step(params, adamw_init(params), batch)


def test_loss_decreases_30_steps():
    cfg, _ = tiny(remat=False)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=32,
                            global_batch=8, seed=0, branching=2)
    step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=10))
    p = transformer.init_params(torch.Generator().manual_seed(1), cfg)
    o = adamw_init(p)
    losses = []
    for i in range(30):
        p, o, m = step_fn(p, o, as_torch(ds.batch(i)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, \
        f"no learning: {losses[0]:.3f} -> {losses[-1]:.3f}"
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "whisper_medium"])
def test_remat_changes_no_gradient(arch, monkeypatch):
    """Remat on and off give the same step, and remat checkpoints every
    period (every decoder layer), only when grad is enabled."""
    module = encdec if arch == "whisper_medium" else transformer
    calls = []
    real = module.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)

    monkeypatch.setattr(module, "checkpoint", counting)
    out = []
    for remat in (True, False):
        cfg, params = tiny(arch, remat=remat, compute_dtype="float32")
        batch = as_torch(make_batch_for(cfg, 2, 16))
        make = make_whisper_train_step if cfg.is_encoder_decoder \
            else make_train_step
        out.append(make(cfg)(params, adamw_init(params), batch))
    n = cfg.num_layers if cfg.is_encoder_decoder else cfg.num_periods()
    assert len(calls) == n
    assert all(kw["use_reentrant"] is False for kw in calls)
    (pa, oa, ma), (pb, ob, mb) = out
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for a, b in zip(leaves((pa, oa)), leaves((pb, ob))):
        assert torch.equal(a, b)
    with torch.no_grad():
        if cfg.is_encoder_decoder:
            encdec.decode_train(params, batch["tokens"],
                                batch["audio_embeds"],
                                dataclasses.replace(cfg, remat=True))
        else:
            transformer.forward(params, batch["tokens"],
                                dataclasses.replace(cfg, remat=True),
                                mode="train")
    assert len(calls) == n


def test_pallas_config_refuses_to_train():
    cfg, params = tiny(attn_impl="pallas")
    batch = as_torch(make_batch_for(cfg, 2, 16))
    # the first kernel the step's forward reaches is the pre-attention norm
    with pytest.raises(RuntimeError, match="add_norm has no backward"):
        make_train_step(cfg)(params, adamw_init(params), batch)


def test_train_step_leaves_callers_params_without_grad():
    cfg, params = tiny()
    batch = as_torch(make_batch_for(cfg, 2, 16))
    before = clone(params)
    out, _, _ = train_loop.make_train_step(cfg)(params, adamw_init(params),
                                                batch)
    assert out is params
    for a, b in zip(leaves(params), leaves(before)):
        assert not a.requires_grad and a.grad is None
    assert any(not torch.equal(a, b)
               for a, b in zip(leaves(params), leaves(before)))
