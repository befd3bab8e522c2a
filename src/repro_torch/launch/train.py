"""End-to-end training driver: train a ~100M-parameter LM for a few hundred
steps on one device, with fault-tolerant checkpointing (atomic commit +
async snapshots + restart-from-latest) and optional int8 error-feedback
gradient compression on the DP path. The twin of the JAX package's
``launch/train.py``: the same presets, flags, log lines and checkpoint
layout (either package resumes from the other's checkpoints).

  PYTHONPATH=src python -m repro_torch.launch.train --steps 300 --preset 100m
  PYTHONPATH=src python -m repro_torch.launch.train --resume --steps 400  # restart
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --preset smoke --steps 20

``--device`` is ``cuda`` (the default; no card is an error) or ``cpu``.
The parameters are drawn from a ``torch.Generator`` seeded 0 on the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.engines import resolve_device
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.training.checkpoint import AsyncCheckpointer, restore_latest
from repro_torch.training.compression import compress_grads, ef_init
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)
from repro_torch.training.train_loop import (cross_entropy_loss,
                                             value_and_grads)
from repro_torch.training.tree import leaves, unflatten_like


PRESETS = {
    # ~100M params: 12L x 640d x 2560ff, 16k vocab
    "100m": dict(num_layers=12, d_model=640, num_heads=10, num_kv_heads=10,
                 head_dim=64, d_ff=2560, vocab_size=16384),
    # ~20M: CI-speed variant
    "20m": dict(num_layers=6, d_model=384, num_heads=6, num_kv_heads=6,
                head_dim=64, d_ff=1536, vocab_size=8192),
}


def build_config(arch: str, preset: str) -> ModelConfig:
    cfg = get_config(arch)
    if preset == "smoke":
        return smoke_config(cfg)
    return dataclasses.replace(
        cfg, **PRESETS[preset],
        moe_num_experts=0, moe_top_k=0, moe_d_ff=0,   # dense preset
        sliding_window=0, logical_vocab_size=0, remat=False,
        compute_dtype="float32")


def _loss_fn(cfg: ModelConfig):
    def loss_fn(params, batch):
        logits, aux = transformer.forward(params, batch["tokens"], cfg,
                                          mode="train")
        return (cross_entropy_loss(logits, batch["labels"]) + 0.01 * aux,)
    return loss_fn


def make_compressed_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """Train step carrying an error-feedback residual (int8 grad path)."""
    loss_fn = _loss_fn(cfg)

    def step(params, opt_state, residual, batch):
        (loss,), grads = value_and_grads(loss_fn, params, batch)
        grads, residual = compress_grads(unflatten_like(params, grads),
                                         residual)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                                opt_cfg)
        return params, opt_state, residual, {"loss": loss, "grad_norm": gnorm}

    return step


def make_plain_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    loss_fn = _loss_fn(cfg)

    def step(params, opt_state, batch):
        (loss,), grads = value_and_grads(loss_fn, params, batch)
        params, opt_state, gnorm = adamw_update(
            unflatten_like(params, grads), opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2_3b")
    ap.add_argument("--preset", default="100m", choices=list(PRESETS) + ["smoke"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", action="store_true",
                    help="int8 + error-feedback gradient compression")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the CUDA card (default; no card is an error) or "
                         "the host CPU")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = build_config(args.arch, args.preset)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(100, args.steps // 3))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init_params(gen, cfg)
    opt_state = adamw_init(params)
    residual = ef_init(params) if args.compress else None
    n_params = sum(p.numel() for p in leaves(params))
    print(f"[train] {args.arch} preset={args.preset}: {n_params/1e6:.1f}M "
          f"params, {args.steps} steps, batch {args.batch} x seq {args.seq}"
          + (" [int8-EF grads]" if args.compress else ""))

    start_step = 0
    if args.resume:
        out = restore_latest(args.ckpt_dir, params, opt_state)
        if out is not None:
            start_step, params, opt_state, extra = out
            print(f"[train] resumed from step {start_step}")

    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=args.seq,
                            global_batch=args.batch, seed=0, branching=2)
    step_fn = (make_compressed_step(cfg, opt_cfg) if args.compress
               else make_plain_step(cfg, opt_cfg))
    ckpt = AsyncCheckpointer(args.ckpt_dir)
    history = []
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in ds.batch(step).items()}
        if args.compress:
            params, opt_state, residual, metrics = step_fn(
                params, opt_state, residual, batch)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % args.log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            tok_s = (step + 1 - start_step) * args.batch * args.seq / dt
            print(f"  step {step + 1:5d}  loss {loss:7.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):7.3f}  "
                  f"{tok_s:,.0f} tok/s")
            history.append({"step": step + 1, "loss": loss})
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, params, opt_state)
    ckpt.wait()
    if history:
        print(f"[train] loss {history[0]['loss']:.4f} -> "
              f"{history[-1]['loss']:.4f} over {args.steps - start_step} steps")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    return history


if __name__ == "__main__":
    main()
