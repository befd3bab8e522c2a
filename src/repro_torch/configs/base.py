"""Architecture registry + assigned input shapes + smoke-config reduction."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "starcoder2_3b",
    "minitron_8b",
    "phi4_mini_3_8b",
    "minitron_4b",
    "jamba_v0_1_52b",
    "whisper_medium",
    "moonshot_v1_16b_a3b",
    "mixtral_8x22b",
    "falcon_mamba_7b",
    "qwen2_vl_2b",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def applicable_shapes(cfg: ModelConfig) -> List[str]:
    """Shape cells for an arch; long_500k only with sub-quadratic attention
    (skips recorded in DESIGN.md SSArch-applicability)."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        shapes.append("long_500k")
    return shapes


def shape_overrides(cfg: ModelConfig, shape: str) -> ModelConfig:
    """Per-cell config adjustments (e.g. jamba attention switches to a 32k
    sliding window for the 500k-context cell)."""
    if shape == "long_500k" and cfg.family == "hybrid" and not cfg.sliding_window:
        return dataclasses.replace(cfg, sliding_window=32768)
    return cfg


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: tiny widths/embeddings,
    few experts, same structural pattern (periods, MoE/hybrid interleave)."""
    period = cfg.period()
    num_layers = period * (1 if period > 1 else 2)
    kv = 4 if cfg.num_kv_heads == cfg.num_heads else 2
    mrope = (4, 6, 6) if cfg.mrope_sections else ()
    return dataclasses.replace(
        cfg,
        num_layers=num_layers,
        d_model=128,
        num_heads=4,
        num_kv_heads=kv,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        logical_vocab_size=509 if cfg.logical_vocab_size else 0,
        moe_num_experts=min(cfg.moe_num_experts, 4) if cfg.moe_num_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        moe_d_ff=128 if cfg.moe_d_ff else 0,
        ssm_state_dim=8 if cfg.ssm_state_dim else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=16 if cfg.is_encoder_decoder else cfg.encoder_seq,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        mrope_sections=mrope,
        attn_chunk=64,
        ssm_chunk=32,
        max_position=4096,
    )
