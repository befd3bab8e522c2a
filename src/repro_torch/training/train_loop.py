"""Train-step construction: loss, grad, AdamW, optional grad compression.
The port of ``repro.training.train_loop``.

``make_train_step(cfg)`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``, as the reference's does. Gradients come from
``torch.autograd.grad`` over the parameter leaves (through aliases that
share their storage, so the caller's tensors never come to require grad),
and ``adamw_update`` then writes params and moments in place: the returned
trees are the ones passed in. The remat policy comes from ``cfg.remat``
inside the models (``transformer.forward`` with ``mode="train"``,
``encdec.decode_train``).

Training runs the plain torch paths (``attn_impl="xla"``, the reference's
default); the kernels of ``attn_impl="pallas"`` have no backward and refuse
a differentiable call (``kernels/ops.py``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import TRAIN_LOGITS_AXES
from repro_torch.sharding.logical import (current_mesh, local_region,
                                          logical_split)
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)
from repro_torch.training.tree import leaves, unflatten_like


def cross_entropy_loss(logits, labels, logical_vocab: int = 0):
    """Next-token CE (labels already shifted by the data pipeline). Under
    rules and a mesh that split the vocabulary (the layout a train step's
    logits come in, ``layers.TRAIN_LOGITS_AXES``), each rank takes its own
    vocabulary shard (``_VocabParallelCE``); otherwise each token's loss is
    taken on the rank that holds the token, the vocabulary whole
    (``local_region``)."""
    axes = TRAIN_LOGITS_AXES
    dims, offset = logical_split(logits, -1, *axes)
    if dims:
        mesh = current_mesh()
        groups = [(mesh, d) for d in dims]
        (loss,) = local_region(
            lambda lg, lb: (_VocabParallelCE.apply(lg, lb, offset, groups),),
            (logits, labels), (axes, axes[:-1]), (axes[:-1],))
        return torch.mean(loss)

    def token_loss(logits, labels):
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return (lse - gold,)

    tokens = ("batch", "seq_q")
    (loss,) = local_region(token_loss, (logits, labels),
                           ((*tokens, None), tokens), (tokens,))
    return torch.mean(loss)


class _VocabParallelCE(torch.autograd.Function):
    """Each token's CE from this rank's vocabulary shard of its logits
    [..., Vl] (global columns ``offset``..``offset + Vl``), the shards of
    ``groups`` (``(mesh, mesh dim)`` pairs) holding the rest: the local max
    all-reduced by max, the local sum of ``exp(x - max)`` all-reduced by
    sum (``lse = max + log sum``), the gold logit from the rank whose slice
    holds the label, all-reduced as a partial sum. A padded vocabulary's
    columns are at ``layers.NEG_INF``, finite, so max and sum stay finite.
    The backward is ``softmax - onehot`` on the local shard, no
    collective."""

    @staticmethod
    def forward(ctx, logits, labels, offset, groups):
        from torch.distributed import _functional_collectives as funcol

        def all_reduce(t, op):
            for group in groups:
                t = funcol.all_reduce(t, op, group)
                if isinstance(t, funcol.AsyncCollectiveTensor):
                    t = t.wait()
            return t

        x = logits.float()
        m = all_reduce(x.amax(dim=-1), "max")
        s = all_reduce(torch.exp(x - m[..., None]).sum(dim=-1), "sum")
        lse = m + torch.log(s)
        # each label's column in this shard (clamped into it), and whether
        # the shard holds it
        local = labels.long() - offset
        held = (local >= 0) & (local < x.shape[-1])
        local = local.clamp(0, x.shape[-1] - 1)
        gold = torch.where(held, torch.gather(x, -1, local[..., None])[..., 0],
                           0.0)
        ctx.save_for_backward(logits, lse, local, held)
        return lse - all_reduce(gold, "sum")

    @staticmethod
    def backward(ctx, grad):
        logits, lse, local, held = ctx.saved_tensors
        g = torch.exp(logits.float() - lse[..., None]) * grad[..., None]
        g.scatter_add_(-1, local[..., None],
                       -torch.where(held, grad, 0.0)[..., None])
        return g.to(logits.dtype), None, None, None


def value_and_grads(loss_fn, params, *args):
    """(loss_fn's outputs, the gradient of its first output with respect to
    each leaf of ``params``, in flattening order). ``loss_fn`` sees aliases
    of the leaves that require grad; a leaf the loss does not reach gets a
    zero gradient, as ``jax.grad`` gives it."""
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        out = loss_fn(unflatten_like(params, live), *args)
        grads = torch.autograd.grad(out[0], live, allow_unused=True,
                                    materialize_grads=True)
    return tuple(o.detach() for o in out), list(grads)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    aux_weight: float = 0.01, compressor=None,
                    accum_steps: int = 1):
    """Decoder-LM train step (all non-enc-dec architectures).

    ``accum_steps > 1`` splits the batch into microbatches whose gradients
    are summed in float32 and divided by ``accum_steps`` before one
    optimizer update (activation memory scales with the microbatch while
    the numerics match the full-batch step)."""

    def loss_fn(params, batch):
        logits, aux = transformer.forward(
            params, batch["tokens"], cfg,
            positions=batch.get("positions"), mode="train")
        ce = cross_entropy_loss(logits, batch["labels"],
                                cfg.logical_vocab_size)
        return ce + aux_weight * aux, ce, aux

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if accum_steps > 1:
            def split(t):
                b = t.shape[0]
                if b % accum_steps:
                    raise ValueError(
                        f"batch {b} not divisible by accum_steps {accum_steps}")
                return t.reshape(accum_steps, b // accum_steps, *t.shape[1:])

            micro = {k: split(v) for k, v in batch.items()}
            g_sum = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves(params)]
            ce_sum = aux_sum = 0.0
            for i in range(accum_steps):
                (_, ce, aux), g = value_and_grads(
                    loss_fn, params, {k: v[i] for k, v in micro.items()})
                for acc, gi in zip(g_sum, g):
                    acc.add_(gi.float())
                ce_sum, aux_sum = ce_sum + ce, aux_sum + aux
            grads = [g / accum_steps for g in g_sum]
            ce, aux = ce_sum / accum_steps, aux_sum / accum_steps
        else:
            (_, ce, aux), grads = value_and_grads(loss_fn, params, batch)
        grads = unflatten_like(params, grads)
        if compressor is not None:
            grads, opt_state = compressor(grads, opt_state)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                                opt_cfg)
        metrics = {"loss": ce, "aux_loss": aux, "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step


def make_whisper_train_step(cfg: ModelConfig,
                            opt_cfg: AdamWConfig = AdamWConfig()):
    """Enc-dec train step: teacher-forced decoder over audio embeddings."""

    def loss_fn(params, batch):
        logits = encdec.decode_train(params, batch["tokens"],
                                     batch["audio_embeds"], cfg)
        return (cross_entropy_loss(logits, batch["labels"],
                                   cfg.logical_vocab_size),)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        (loss,), grads = value_and_grads(loss_fn, params, batch)
        params, opt_state, gnorm = adamw_update(
            unflatten_like(params, grads), opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def init_train_state(gen: torch.Generator, cfg: ModelConfig):
    init = encdec.init_params if cfg.is_encoder_decoder \
        else transformer.init_params
    params = init(gen, cfg)
    return params, adamw_init(params)
