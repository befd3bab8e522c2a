"""AdamW over parameter trees: the port of ``repro.training.optimizer``.

The arithmetic is the reference's, step for step: the global gradient norm
over every leaf in float32, taken before any update; clipping by
``min(1, clip / max(norm, 1e-12))``; the learning rate of the step before
the increment (linear warmup); bias corrections of the step after it;
``delta = mhat / (sqrt(vhat) + eps) + wd * p``, with weight decay inside the
update (``torch.optim.AdamW`` decays decoupled and clips nothing, so it is
not this); moments in float32 and the result cast back to the parameter's
dtype.

Where the reference, jitted with donated buffers, updates in place, the
port does so explicitly: ``adamw_update`` writes each leaf of the params,
``mu`` and ``nu`` in place, a slice of at most ``UPDATE_CHUNK`` elements at
a time, so the update needs two chunk-sized temporaries and never a second
copy of the parameters or moments (at 3 B parameters a functional update
would need another 36 GB).

Sharded leaves (DTensors on a mesh, ``repro_torch.sharding``): the update
is elementwise, so each rank updates its local shard of each leaf, after
the leaf's gradient is brought to its parameter's placements; the global
norm takes each sharded leaf's local sum of squares as a partial sum over
the mesh dims that shard it and all-reduces it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.training.tree import leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor      # int32, 0-d
    mu: Any                 # float32, the params' nesting
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100


UPDATE_CHUNK = 1 << 24      # elements of a leaf updated at a time


def adamw_init(params) -> OptState:
    device = leaves(params)[0].device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32,
                                       memory_format=torch.contiguous_format)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    return cfg.lr * warm


def _chunks(t: torch.Tensor):
    if not t.is_contiguous():
        return (t,)
    return t.view(-1).split(UPDATE_CHUNK)


def _local(t):
    """A DTensor's local shard; any other tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares,
    a slice at a time. ``torch.sum`` reduces in a tree (pairwise on the
    host); ``torch.linalg.vector_norm`` accumulates in float32 runs long
    enough to be 4e-4 off at 2^24 elements, and the card's and the host's
    norms of one model's gradients then differ. A DTensor leaf (sharded or
    replicated, not partial) adds its shard's sum of squares, all-reduced
    over the mesh dims that shard it."""
    sq = []
    for g in leaves(grads):
        if isinstance(g, DTensor):
            part = torch.stack([c.float().square().sum()
                                for c in _chunks(g.to_local())]).sum()
            sq.append(DTensor.from_local(
                part, g.device_mesh, [Partial() if p.is_shard() else
                                      Replicate() for p in g.placements]
            ).full_tensor())
        else:
            sq.extend(c.float().square().sum() for c in _chunks(g))
    return torch.stack(sq).sum().sqrt()


def _as_param(g, p):
    """A DTensor gradient at its parameter's placements (a partial sum
    reduced, a replicated gradient sliced to the parameter's shard)."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


@torch.no_grad()
def adamw_update(grads, state: OptState, params,
                 cfg: AdamWConfig = AdamWConfig()):
    """Returns (params, new_state, grad_norm). ``params``, ``state.mu`` and
    ``state.nu`` are updated IN PLACE (the returned trees are the same
    objects); ``grads`` is read only."""
    grads = [_as_param(g, p) for g, p in zip(leaves(grads), leaves(params))]
    gnorm = global_norm(grads)
    if cfg.grad_clip:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    step = state.step + 1
    lr = _schedule(cfg, _local(state.step))
    stepf = _local(step).float()
    b1c = 1 - torch.tensor(cfg.b1, dtype=torch.float32,
                           device=stepf.device) ** stepf
    b2c = 1 - torch.tensor(cfg.b2, dtype=torch.float32,
                           device=stepf.device) ** stepf

    for p, g, m, v in zip(leaves(params), grads, leaves(state.mu),
                          leaves(state.nu)):
        for pc, gc, mc, vc in zip(*(_chunks(_local(t)) for t in (p, g, m,
                                                                   v))):
            g32 = gc.float() * scale
            mc.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
            vc.mul_(cfg.b2).add_(g32.square_(), alpha=1 - cfg.b2)
            denom = torch.div(vc, b2c).sqrt_().add_(cfg.eps)
            delta = torch.div(mc, b1c).div_(denom)
            del denom
            delta.add_(pc.float(), alpha=cfg.weight_decay).mul_(lr)
            if pc.dtype == torch.float32:
                pc.sub_(delta)
            else:
                pc.copy_(pc.float().sub_(delta))
    return params, OptState(step=step, mu=state.mu, nu=state.nu), gnorm
