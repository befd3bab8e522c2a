"""Logical axis rules with divisibility fallback: the port of
``repro.sharding.logical``.

MaxText-style indirection: model code annotates tensors with *logical* axis
names ("batch", "heads", "mlp", ...); a rule table maps logical names to
mesh axes. Resolution drops any mesh axis that does not evenly divide the
dimension (24 attention heads on a 16-way ``model`` axis, 8 Mixtral
experts), which keeps every (arch x shape x mesh) cell traceable without
per-arch special cases.

The tables and the resolution are the reference's. Where the reference
hands a ``PartitionSpec`` to ``with_sharding_constraint``, the port turns
the same spec into DTensor placements over a ``DeviceMesh``
(``placements``) and redistributes a DTensor to them
(``logical_constraint``). A plain tensor, or any tensor without active
rules and a mesh, passes through unchanged: on one card every hint is a
no-op.
"""
from __future__ import annotations

import contextlib
import math
from typing import Mapping, Optional, Sequence, Tuple

import torch

# logical axis -> ordered candidate mesh axes. Earlier axes are applied first;
# each mesh axis may be used at most once per tensor.
LogicalRules = Mapping[str, Tuple[str, ...]]

# Training: FSDP on "data" (+"pod"), TP on "model", residual-stream sequence
# parallelism on "model" (the carry between blocks is [batch/data,
# seq/model, d]; the projections where "mlp"/"heads"/"ssm_inner" take over
# the axis gather and scatter it).
TRAIN_RULES: LogicalRules = {
    "batch": ("pod", "data"),
    "embed": ("data",),          # FSDP shard of weight d_model dims
    "embed_act": (),             # activation d_model stays replicated
    "seq_q": ("model",),         # residual-stream sequence sharding
    "seq_attn": (),              # attention-internal seq (heads take "model")
    "heads": ("model",),
    "kv_heads": ("model",),
    "qkv": ("model",),           # fused q/kv projection output dim
    "mlp": ("model",),
    "moe_mlp": ("model",),
    "experts": ("model",),
    # MoE dispatch groups never take the model axis: a model-sharded group
    # dim competes with the expert FFN's f dim for the same axis. Groups
    # shard (pod, data); f shards model (TP), or experts take model under
    # true expert parallelism.
    "moe_groups": ("pod", "data"),
    "moe_tokens": (),                  # within-group token dim
    "vocab": ("model",),
    "kv_seq": (),
    "ssm_inner": ("model",),
    "ssm_state": (),
    "conv": (),
    "layers": (),
    "stage": (),
}

# Serving/decode: TP on "model", batch on ("pod","data"); weights replicated
# on the data axis by default (no FSDP gather in the decode loop);
# ``rules_for`` re-enables FSDP when a 16-way TP shard exceeds the memory
# budget. KV caches shard seq on whatever batch leaves free.
SERVE_RULES: LogicalRules = {
    **TRAIN_RULES,
    "embed": (),
    "seq_q": (),
    "kv_seq": ("data", "model"),
}


def mesh_axis_sizes(mesh) -> dict:
    """{mesh dim name: size}. Reads only ``mesh_dim_names`` and ``shape``,
    so a stand-in with those two attributes serves as well as a
    ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def rules_for(cfg, mesh, mode: str,
              hbm_budget_bytes: float = 8e9) -> LogicalRules:
    """Arch-aware rule table (divisibility quirks + memory-driven FSDP), the
    reference's branches:

    - serve: if a pure-TP (model-axis) bf16 weight shard would exceed
      ``hbm_budget_bytes`` (mixtral-8x22b), weight d_model dims also shard
      on "data" (FSDP-gathered serving);
    - heads that do not divide the model axis shard attention by the query
      sequence instead;
    - prefill of a non-MoE, non-SSM model is fully sequence-parallel, with
      weights replicated on the model axis (FSDP on "data" from 12 GB of
      bf16 weights). SSMs are excluded: the scan runs along the sequence.
    """
    rules = dict(TRAIN_RULES if mode == "train" else SERVE_RULES)
    axis_sizes = mesh_axis_sizes(mesh)
    model_n = axis_sizes.get("model", 1)
    if mode != "train":
        tp_bytes = cfg.param_count() * 2 / model_n
        if tp_bytes > hbm_budget_bytes:
            rules["embed"] = ("data",)
    heads_split = cfg.num_heads and model_n > 1 and cfg.num_heads % model_n
    if heads_split:
        rules["seq_attn"] = ("model",)
    if mode == "prefill" and not cfg.moe_num_experts \
            and cfg.family != "ssm":
        rules["seq_q"] = ("model",)
        rules["seq_attn"] = ("model",)
        rules["qkv"] = ()
        rules["mlp"] = ()
        rules["heads"] = ()
        rules["kv_heads"] = ()
        if cfg.param_count() * 2 >= 12e9:
            rules["embed"] = ("data",)
            rules["vocab"] = ()
    if cfg.moe_num_experts and model_n > 1 \
            and cfg.moe_num_experts % model_n == 0:
        # true expert parallelism: experts own "model", groups own "data"
        rules["moe_groups"] = ("pod", "data")
    return rules


class _RulesState:
    """The active rules and mesh, process-wide where the reference keeps
    them per thread: the backward's recompute of a rematerialised block
    runs on the autograd engine's device thread, and it must trace under
    the rules its forward saw."""

    def __init__(self):
        self.rules: Optional[LogicalRules] = None
        self.mesh = None


_STATE = _RulesState()


@contextlib.contextmanager
def use_rules(rules: Optional[LogicalRules], mesh=None):
    """Activate a logical-rule table (and optionally a mesh) for model
    code."""
    prev = (_STATE.rules, _STATE.mesh)
    _STATE.rules, _STATE.mesh = rules, mesh
    try:
        yield
    finally:
        _STATE.rules, _STATE.mesh = prev


def current_rules() -> Optional[LogicalRules]:
    return _STATE.rules


def current_mesh():
    return _STATE.mesh


def resolve_spec(shape: Sequence[int],
                 logical_axes: Sequence[Optional[str]], mesh,
                 rules: LogicalRules) -> tuple:
    """Map logical axes to the reference's per-dimension spec: for each
    dimension ``None``, a mesh axis name, or a tuple of names (mesh axes
    that do not divide the dimension are dropped), trailing ``None``s
    stripped. Equal to ``tuple(P)`` of the reference's result."""
    if len(shape) != len(logical_axes):
        raise ValueError(
            f"shape rank {len(shape)} != logical axes {logical_axes}")
    used: set = set()
    out = []
    axis_sizes = mesh_axis_sizes(mesh)
    for dim, name in zip(shape, logical_axes):
        if name is None:
            out.append(None)
            continue
        chosen = []
        remaining = dim
        for ax in rules.get(name, ()):
            if ax not in axis_sizes or ax in used:
                continue
            sz = axis_sizes[ax]
            if remaining % sz == 0:
                chosen.append(ax)
                used.add(ax)
                remaining //= sz
        if not chosen:
            out.append(None)
        elif len(chosen) == 1:
            out.append(chosen[0])
        else:
            out.append(tuple(chosen))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements for a resolved spec, one per mesh dim in mesh
    order: ``Shard(d)`` where tensor dim d names that mesh axis, else
    ``Replicate()``. A tensor dim split over several mesh axes is split by
    them in mesh order (the first named the major one, as a tuple in a
    ``PartitionSpec`` orders them), so a tuple must name its axes in mesh
    order; every rule of the tables does."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} does not name its mesh "
                             f"axes in mesh order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


class _Constrain(torch.autograd.Function):
    """Redistribute to ``place``; the gradient goes back to the input's
    placements (a partial one replicated), as DTensor's ``redistribute``
    sends it, also where the input already had ``place``: so a gradient
    always meets the operation before the constraint in the layout its
    forward had, never in one that an op after the constraint chose."""

    @staticmethod
    def forward(ctx, x, place):
        from torch.distributed.tensor import Replicate

        ctx.in_place = tuple(Replicate() if p.is_partial() else p
                             for p in x.placements)
        if tuple(x.placements) == place:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, place)

    @staticmethod
    def backward(ctx, grad):
        if _is_dtensor(grad) and tuple(grad.placements) != ctx.in_place:
            grad = grad.redistribute(grad.device_mesh, ctx.in_place)
        return grad, None


def logical_constraint(x: torch.Tensor, *logical_axes: Optional[str]):
    """The twin of ``with_sharding_constraint`` by logical axis names:
    under active rules and a mesh, a DTensor is redistributed to the
    resolved placements (under autograd through ``_Constrain``); any other
    tensor is returned unchanged."""
    rules, mesh = _STATE.rules, _STATE.mesh
    if rules is None or mesh is None or not _is_dtensor(x):
        return x
    want = placements(resolve_spec(x.shape, logical_axes, mesh, rules), mesh)
    if x.requires_grad and torch.is_grad_enabled():
        return _Constrain.apply(x, want)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def local_offset(x, dim: int) -> int:
    """The global index of this rank's first element along ``dim`` of a
    DTensor (0 for any other tensor)."""
    if not _is_dtensor(x):
        return 0
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    return compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)[1][dim]


def logical_split(x, dim: int, *logical_axes: Optional[str]):
    """(mesh dims, offset): under rules and a mesh, the mesh dims of more
    than one rank that split ``dim`` of a DTensor ``x`` placed by
    ``logical_axes``, and this rank's global index of its first element
    along ``dim``; ``((), 0)`` for any other tensor, or a dim no mesh dim
    splits."""
    rules, mesh = _STATE.rules, _STATE.mesh
    if rules is None or mesh is None or not _is_dtensor(x):
        return (), 0
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    dim %= x.ndim
    place = placements(resolve_spec(x.shape, logical_axes, mesh, rules), mesh)
    dims = tuple(i for i, p in enumerate(place)
                 if p.is_shard(dim) and mesh.size(i) > 1)
    if not dims:
        return (), 0
    return dims, compute_local_shape_and_global_offset(x.shape, mesh,
                                                       place)[1][dim]


def logical_new(factory, shape: Sequence[int],
                *logical_axes: Optional[str]):
    """A tensor the model makes itself (a zeroed cache, a state) of global
    ``shape``: ``factory(shape)`` off a mesh; under rules and a mesh a
    DTensor placed by its logical axes, each rank making only its own
    shard, ``factory(local shape)``, no collective."""
    rules, mesh = _STATE.rules, _STATE.mesh
    shape = torch.Size(shape)
    if rules is None or mesh is None:
        return factory(shape)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    place = placements(resolve_spec(shape, logical_axes, mesh, rules), mesh)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, place)
    return DTensor.from_local(factory(torch.Size(local)), mesh, place,
                              run_check=False, shape=shape,
                              stride=_contiguous_strides(shape))


def logical_reshape(x: torch.Tensor, shape: Sequence[int],
                    *logical_axes: Optional[str]):
    """``x.reshape(shape)`` followed by ``logical_constraint(.., *axes)``.
    A DTensor is first placed, in its own shape, as the reshaped tensor's
    axes place it (a shard of a split dim moves to the dim it splits out
    of): DTensor refuses to split a sharded dim into parts that its shard
    count does not divide (24 heads out of a 16-way [heads*hd] shard),
    which the reference's partitioner reshards on its own."""
    rules, mesh = _STATE.rules, _STATE.mesh
    if rules is None or mesh is None or not _is_dtensor(x):
        return x.reshape(shape)
    want = placements(resolve_spec(shape, logical_axes, mesh, rules), mesh)
    major = {}          # target dim -> source dim it is the major part of
    src, acc = 0, 1
    for d, n in enumerate(shape):
        if acc == 1:
            major[d] = src
        acc *= n
        while src < x.ndim and acc % x.shape[src] == 0 and acc >= x.shape[src]:
            acc //= x.shape[src]
            src += 1
    if all(not p.is_shard() or p.dim in major for p in want):
        from torch.distributed.tensor import Shard

        src_place = tuple(Shard(major[p.dim]) if p.is_shard() else p
                          for p in want)
        if src_place != tuple(x.placements):
            x = x.redistribute(x.device_mesh, src_place)
    return logical_constraint(x.reshape(shape), *logical_axes)


def gather_leading(x, last: Optional[str] = None):
    """A DTensor activation [B, S, ..., K] before a product with a weight:
    every shard of a leading dim but the first (the residual stream's
    sequence dim under sequence parallelism) gathered, the all-gather the
    reference's partitioner inserts before a tensor-parallel projection.
    The product flattens the leading dims, and DTensor either refuses to
    flatten a dim split by several mesh axes or searches redistribution
    paths for it at length on a three-axis mesh.

    ``last``, the logical axis of K for a row-parallel product (the
    weight's contracted dim is split over that axis), moves a freed mesh
    axis onto K in the same redistribution where the rules put K there: K
    split as the weight's rows are, the product and its weight gradient
    are computed on each rank's rows. Kept replicated, DTensor would
    gather the weight and compute the whole product, and its backward the
    whole weight gradient, on every rank of that axis. Any other tensor is
    returned as it is."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    want = [Replicate() if p.is_shard() and 0 < p.dim < x.ndim - 1
            else p for p in x.placements]
    rules, mesh = _STATE.rules, _STATE.mesh
    if last is not None and rules is not None and mesh is not None:
        k_place = placements(resolve_spec(x.shape[-1:], (last,), mesh,
                                          rules), mesh)
        want = [Shard(x.ndim - 1) if k.is_shard() and p.is_replicate()
                else p for k, p in zip(k_place, want)]
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(want))


def local_region(fn, args, in_axes, out_axes, partial=()):
    """``fn(*args)`` computed on each rank's local shards, for a region in
    which no value crosses a shard, such as the selective scan, which runs
    along the sequence independently for each (batch, channel), or an MoE
    layer's routing, independent for each group.

    Off a mesh, or with no DTensor among ``args``, this is ``fn(*args)``.
    Under rules and a mesh, each DTensor argument is first constrained to
    its logical axes in ``in_axes`` (the redistribution that needs), the
    plain tensors and ``None``s pass as they are, ``fn`` runs on the local
    tensors, and each output becomes a DTensor again, its dim with logical
    name n sharded as the inputs' dims named n were; ``partial`` gives, per
    output, logical axes over whose mesh axes that output is a partial sum
    (``fn`` summed over a dim sharded on them). The region's inner operations
    dispatch as plain tensors: the result is the same, DTensor's planner
    has no index bookkeeping to place, and a trace of thousands of small
    operations (a scan's tree, chunk by chunk) does not pay DTensor's
    dispatch on each."""
    from torch.distributed.tensor import DTensor, Partial

    rules, mesh = _STATE.rules, _STATE.mesh
    if rules is None or mesh is None or not any(
            isinstance(a, DTensor) for a in args):
        return fn(*args)
    sizes = mesh_axis_sizes(mesh)
    by_name: dict = {}
    local = []
    for a, axes in zip(args, in_axes):
        if not isinstance(a, DTensor):
            local.append(a)
            continue
        spec = resolve_spec(a.shape, axes, mesh, rules)
        a = logical_constraint(a, *axes)
        for name, entry in zip(axes, spec + (None,) * len(axes)):
            if name is not None:
                got = () if entry is None else (
                    entry if isinstance(entry, tuple) else (entry,))
                if by_name.setdefault(name, got) != got:
                    raise ValueError(f"logical axis {name!r} resolved to "
                                     f"{by_name[name]} and {got}")
        local.append(a.to_local())
    outs = fn(*local)
    names = list(mesh.mesh_dim_names)
    wrapped = []
    for i, (o, axes) in enumerate(zip(outs, out_axes)):
        partial_dims = {names.index(a) for n in (partial[i] if partial
                                                 else ())
                        for a in by_name.get(n, ())}
        spec = tuple(by_name.get(n) or None if n is not None else None
                     for n in axes)
        shape = [dim * math.prod(sizes[a] for a in (e or ()))
                 for dim, e in zip(o.shape, spec)]
        place = tuple(Partial() if d in partial_dims else p
                      for d, p in enumerate(placements(spec, mesh)))
        wrapped.append(DTensor.from_local(
            o.contiguous(), mesh, place, run_check=False,
            shape=torch.Size(shape), stride=_contiguous_strides(shape)))
    return tuple(wrapped)


def _contiguous_strides(shape) -> tuple:
    strides, acc = [], 1
    for dim in reversed(shape):
        strides.append(acc)
        acc *= dim
    return tuple(reversed(strides))
