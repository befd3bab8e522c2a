"""Traceable (function, abstract inputs, placements) per (arch x shape x
mesh): the port of ``repro.launch.specs``.

Every assigned cell becomes a ``LoweredSpec``: the step function (train /
prefill / decode), meta-tensor stand-ins for all inputs (no storage), and
DTensor placements resolved through the logical rule tables.
``build_cell`` is what the dry run calls; ``lower_cell`` turns the
stand-ins into meta DTensors on the mesh and runs the step once under the
cell's rules, the port's counterpart of ``jit(...).lower``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, applicable_shapes, get_config
from repro_torch.configs.base import shape_overrides
from repro_torch.models import encdec, kvcache, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.logical import (placements, resolve_spec,
                                          rules_for, use_rules)
from repro_torch.sharding.partition import param_shardings
from repro_torch.training.optimizer import OptState, adamw_init
from repro_torch.training.train_loop import (make_train_step,
                                             make_whisper_train_step)


@dataclasses.dataclass
class LoweredSpec:
    arch: str
    shape: str
    fn: Callable
    abstract_args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    donate_argnums: Tuple[int, ...]
    cfg: ModelConfig
    rules: Any


def _tokens_spec(batch, seq):
    return torch.empty((batch, seq), dtype=torch.int32, device="meta")


def _serve_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, param_dtype="bfloat16", remat=False)


def _positions_spec(cfg, batch, seq):
    if cfg.mrope_sections:
        return torch.empty((3, batch, seq), dtype=torch.int32,
                           device="meta")
    return None


def _sharding(mesh, rules, t, axes):
    return mesh, placements(resolve_spec(t.shape, axes, mesh, rules), mesh)


def _ep_split(cfg: ModelConfig, mesh) -> int:
    """Virtual-expert EP split: when the expert count does not divide the
    model axis but a half-width split does, split each expert into half-ff
    virtual experts so expert parallelism applies exactly (mixtral 8e on a
    16-way axis -> split 2). SwiGLU is elementwise in ff -> exact."""
    # Measured net-negative under GSPMD in the reference (dispatch/combine
    # gathers lower to mask+all-reduce that outweighs the removed
    # partial-sum all-reduces): exact and tested, but opt-in.
    if not cfg.moe_num_experts or not os.environ.get("REPRO_EP_SPLIT"):
        return 1
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    model_n = sizes.get("model", 1)
    e, ff = cfg.moe_num_experts, (cfg.moe_d_ff or cfg.d_ff)
    if model_n <= 1 or e % model_n == 0:
        return 1
    if model_n % e == 0:
        split = model_n // e
        if ff % split == 0 and (ff // split) % 128 == 0:  # lane-aligned
            return split
    return 1


def _opt_state(abstract, p_axes, mesh, rules):
    opt = adamw_init(abstract)
    opt_axes = OptState(step=(), mu=p_axes, nu=p_axes)
    return opt, param_shardings(opt, opt_axes, mesh, rules)


def build_cell(arch: str, shape: str, mesh,
               n_periods: Optional[int] = None) -> LoweredSpec:
    """``n_periods`` overrides the depth (in periods), as the reference's
    does; the port's dry run traces every layer eagerly and needs no
    shallow variants to extrapolate from."""
    cfg = get_config(arch)
    if shape not in applicable_shapes(cfg):
        raise ValueError(f"{arch} x {shape}: skipped "
                         "(not an applicable shape of this arch)")
    cfg = shape_overrides(cfg, shape)
    cfg = dataclasses.replace(cfg, moe_ep_split=_ep_split(cfg, mesh))
    if n_periods is not None:
        cfg = dataclasses.replace(
            cfg, num_layers=cfg.period() * n_periods, scan_layers=False,
            encoder_layers=n_periods if cfg.is_encoder_decoder else 0)
    spec = SHAPES[shape]
    b, s = spec.global_batch, spec.seq_len
    mode = spec.kind                       # "train" | "prefill" | "decode"
    if mode != "train":
        cfg = _serve_cfg(cfg)
    rules = rules_for(cfg, mesh, mode)

    if cfg.is_encoder_decoder:
        return _build_encdec_cell(arch, shape, cfg, mesh, rules, spec)

    p_axes = transformer.param_axes(cfg)
    abstract = transformer.abstract_params(cfg)
    p_shard = param_shardings(abstract, p_axes, mesh, rules)

    if spec.kind == "train":
        step = make_train_step(cfg)
        opt, opt_shard = _opt_state(abstract, p_axes, mesh, rules)
        batch = {"tokens": _tokens_spec(b, s), "labels": _tokens_spec(b, s)}
        batch_axes = {"tokens": ("batch", None), "labels": ("batch", None)}
        if cfg.mrope_sections:
            batch["positions"] = _positions_spec(cfg, b, s)
            batch_axes["positions"] = (None, "batch", None)
        b_shard = param_shardings(batch, batch_axes, mesh, rules)
        return LoweredSpec(arch, shape, step, (abstract, opt, batch),
                           (p_shard, opt_shard, b_shard), (0, 1), cfg, rules)

    if spec.kind == "prefill":
        width = kvcache.cache_width(cfg, s)

        def prefill_fn(params, tokens, positions=None):
            return transformer.prefill(params, tokens, cfg, width,
                                       positions=positions)

        tokens = _tokens_spec(b, s)
        args = [abstract, tokens]
        shards = [p_shard, _sharding(mesh, rules, tokens, ("batch", None))]
        if cfg.mrope_sections:
            positions = _positions_spec(cfg, b, s)
            args.append(positions)
            shards.append(_sharding(mesh, rules, positions,
                                    (None, "batch", None)))
        return LoweredSpec(arch, shape, prefill_fn, tuple(args),
                           tuple(shards), (), cfg, rules)

    # decode
    width = kvcache.cache_width(cfg, s)
    cache = kvcache.init_cache(cfg, b, width, device="meta")
    c_shard = param_shardings(cache, kvcache.cache_axes(cfg), mesh, rules)

    def decode_fn(params, token, pos, cache, positions=None):
        return transformer.decode_step(params, token, pos, cache, cfg,
                                       positions=positions)

    token = _tokens_spec(b, 1)
    # the position is a static int in the port's decode step (it indexes
    # the ring on the host), where the reference traces an int32 scalar
    args = [abstract, token, s - 1, cache]
    shards = [p_shard, _sharding(mesh, rules, token, ("batch", None)),
              None, c_shard]
    if cfg.mrope_sections:
        positions = _positions_spec(cfg, b, 1)
        args.append(positions)
        shards.append(_sharding(mesh, rules, positions,
                                (None, "batch", None)))
    return LoweredSpec(arch, shape, decode_fn, tuple(args), tuple(shards),
                       (3,), cfg, rules)


# --------------------------------------------------------------------------- #
# whisper (enc-dec)
# --------------------------------------------------------------------------- #

def _build_encdec_cell(arch, shape, cfg, mesh, rules, spec) -> LoweredSpec:
    b, s = spec.global_batch, spec.seq_len
    p_axes = encdec.param_axes(cfg)
    abstract = encdec.abstract_params(cfg)
    p_shard = param_shardings(abstract, p_axes, mesh, rules)
    f, d = cfg.encoder_seq, cfg.d_model
    audio = torch.empty((b, f, d), dtype=torch.bfloat16, device="meta")
    audio_shard = _sharding(mesh, rules, audio, ("batch", None, None))
    tok_shard = _sharding(mesh, rules, _tokens_spec(b, s), ("batch", None))

    if spec.kind == "train":
        step = make_whisper_train_step(cfg)
        opt, opt_shard = _opt_state(abstract, p_axes, mesh, rules)
        batch = {"tokens": _tokens_spec(b, s), "labels": _tokens_spec(b, s),
                 "audio_embeds": audio}
        b_shard = {"tokens": tok_shard, "labels": tok_shard,
                   "audio_embeds": audio_shard}
        return LoweredSpec(arch, shape, step, (abstract, opt, batch),
                           (p_shard, opt_shard, b_shard), (0, 1), cfg, rules)

    if spec.kind == "prefill":
        def prefill_fn(params, tokens, audio_embeds):
            return encdec.prefill(params, tokens, audio_embeds, cfg,
                                  cache_width=s)
        return LoweredSpec(arch, shape, prefill_fn,
                           (abstract, _tokens_spec(b, s), audio),
                           (p_shard, tok_shard, audio_shard), (), cfg, rules)

    # decode: self cache (ring of width s) + cross cache (encoder K/V)
    hd = cfg.resolved_head_dim

    def empty(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    cache = {"self": {n: empty(cfg.num_layers, b, cfg.num_kv_heads, s, hd)
                      for n in ("k", "v")},
             "cross": {n: empty(cfg.num_layers, b, f, cfg.num_kv_heads, hd)
                       for n in ("k", "v")}}
    c_axes = {"self": {"k": encdec.SELF_AXES, "v": encdec.SELF_AXES},
              "cross": {"k": encdec.CROSS_AXES, "v": encdec.CROSS_AXES}}
    c_shard = param_shardings(cache, c_axes, mesh, rules)
    token = _tokens_spec(b, 1)

    def decode_fn(params, token, pos, cache):
        return encdec.decode_step(params, token, pos, cache, cfg)

    return LoweredSpec(
        arch, shape, decode_fn, (abstract, token, s - 1, cache),
        (p_shard, _sharding(mesh, rules, token, ("batch", None)), None,
         c_shard), (3,), cfg, rules)


# --------------------------------------------------------------------------- #

def _distribute(arg, shard):
    """A meta stand-in (or a tree of them) as meta DTensors with the
    resolved placements: each rank's local shard is a meta tensor of the
    shard's shape."""
    from torch.distributed.tensor import DTensor

    if isinstance(arg, dict):
        return {k: _distribute(v, shard[k]) for k, v in arg.items()}
    if isinstance(arg, OptState):
        return OptState(*(_distribute(a, s) for a, s in zip(arg, shard)))
    if not isinstance(arg, torch.Tensor):
        return arg
    mesh, place = shard
    local = list(arg.shape)
    for i, p in enumerate(place):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(
        torch.empty(local, dtype=arg.dtype, device="meta"), mesh, place,
        run_check=False, shape=arg.shape, stride=arg.stride())


def distributed_args(cell: LoweredSpec):
    """The cell's abstract arguments as meta DTensors on their mesh."""
    return tuple(_distribute(a, s) for a, s in zip(cell.abstract_args,
                                                   cell.in_shardings))


def lower_cell(cell: LoweredSpec, mesh, args=None):
    """Run the cell's step once on meta DTensors under its rules and the
    mesh (tensors the model makes itself, such as positions, masks and
    zero states, join as replicated: ``implicit_replication``). Serving
    steps run without autograd. Returns the step's outputs."""
    from torch.distributed.tensor.experimental import implicit_replication

    args = distributed_args(cell) if args is None else args
    grad = torch.enable_grad() if SHAPES[cell.shape].kind == "train" \
        else torch.no_grad()
    with use_rules(cell.rules, mesh), implicit_replication(), grad:
        return cell.fn(*args)
