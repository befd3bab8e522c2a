"""Model configuration covering every assigned architecture family.

One frozen dataclass describes dense / MoE / hybrid / SSM / enc-dec / VLM
backbones; ``block_pattern()`` expands it into the per-period layer layout the
transformer stack scans over (jamba's 1:7 attn:mamba interleave with MoE every
other layer collapses into a period of 8 slots scanned 4 times).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BlockSlot:
    """One layer inside a scan period."""
    mixer: str       # "attn" | "mamba"
    ffn: Optional[str]  # "mlp" | "moe" | None (mamba1 blocks have no FFN)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0              # per-expert FFN width (0 -> d_ff)
    moe_period: int = 1            # MoE every k-th layer (jamba: 2)
    moe_offset: int = 0
    moe_capacity_factor: float = 1.25
    # virtual-expert EP (§Perf iteration B4): split each expert into
    # ``moe_ep_split`` half-width virtual experts so the expert count divides
    # the model axis (mixtral 8e x split 2 = 16 on a 16-way axis). SwiGLU is
    # elementwise in ff, so the split is mathematically exact. Set per-cell
    # by the launcher from the mesh; 1 = off.
    moe_ep_split: int = 1
    # expert parallelism's cut (the port's): this card holds experts
    # 0 .. moe_experts_held - 1 of the router's moe_num_experts (0 = all of
    # them); choices of the others add nothing here. Needs moe_dropless.
    moe_experts_held: int = 0
    moe_dropless: bool = False     # sorted rows, no capacity, no drop
    moe_renormalize: bool = True   # top-k weights over their sum

    # --- hybrid / ssm ---
    attn_period: int = 1           # jamba: attention every 8th layer
    attn_offset: int = 0           # jamba: offset 4
    ssm_state_dim: int = 0
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_dt_bc_norms: bool = False  # RMSNorms of dt, B, C (jamba's mixer)

    # --- attention details ---
    rope_theta: float = 10000.0
    sliding_window: int = 0        # 0 = full attention
    attn_rope: bool = True         # False: no positional encoding (jamba)
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE half-dim split

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500        # whisper 30 s -> 1500 frames (stub frontend)

    # --- misc ---
    mlp_type: str = "swiglu"       # swiglu | gelu
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    tie_embeddings: bool = False
    logical_vocab_size: int = 0    # unpadded vocab (0 -> vocab_size)
    max_position: int = 1 << 20
    norm_eps: float = 1e-5

    # --- runtime knobs (not architecture) ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = ""       # "" -> same as compute_dtype
    attn_chunk: int = 1024         # KV chunk for the XLA online-softmax path
    ssm_chunk: int = 256           # chunk length for the chunked mamba scan
    remat: bool = True             # checkpoint each scan body in training
    attn_impl: str = "xla"        # xla | pallas
    scan_layers: bool = True

    # ------------------------------------------------------------------ #
    @property
    def kv_dtype(self) -> str:
        return self.kv_cache_dtype or self.compute_dtype

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, math.ceil(self.d_model / 16))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM/hybrid always; attention iff windowed."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    @property
    def has_decode(self) -> bool:
        return True  # every assigned arch has a decoder (whisper is enc-dec)

    def period(self) -> int:
        """Scan-period length: lcm of the structural periods."""
        p = 1
        if self.family == "hybrid":
            p = self.attn_period
        if self.moe_num_experts and self.moe_period > 1:
            p = _lcm(p, self.moe_period)
        return p

    def block_pattern(self) -> Tuple[BlockSlot, ...]:
        """Layer layout of one scan period."""
        slots = []
        for i in range(self.period()):
            if self.family == "ssm":
                slots.append(BlockSlot(mixer="mamba", ffn=None))
                continue
            if self.family == "hybrid":
                is_attn = (i % self.attn_period) == self.attn_offset
                mixer = "attn" if is_attn else "mamba"
            else:
                mixer = "attn"
            if self.moe_num_experts and (i % self.moe_period) == self.moe_offset:
                ffn = "moe"
            else:
                ffn = "mlp"
            slots.append(BlockSlot(mixer=mixer, ffn=ffn))
        return tuple(slots)

    def num_periods(self) -> int:
        p = self.period()
        if self.num_layers % p:
            raise ValueError(f"{self.name}: {self.num_layers} layers not divisible by period {p}")
        return self.num_layers // p

    # --- parameter counting (for roofline MODEL_FLOPS and memory budgeting) ---
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        total = 0
        # embeddings (+ untied head)
        vocab = self.logical_vocab_size or self.vocab_size
        total += vocab * d * (1 if self.tie_embeddings else 2)
        for slot in self.block_pattern():
            n = self.num_periods()
            if slot.mixer == "attn":
                qkv = d * hd * (self.num_heads + 2 * self.num_kv_heads)
                total += n * (qkv + self.num_heads * hd * d + d)
            else:  # mamba
                di, st, rk = self.d_inner, self.ssm_state_dim, self.dt_rank
                total += n * (d * 2 * di + di * self.ssm_conv_width
                              + di * (rk + 2 * st) + rk * di + di * st + di
                              + di * d + d)
                if self.ssm_dt_bc_norms:
                    total += n * (rk + 2 * st)
            if slot.ffn == "mlp":
                mult = 3 if self.mlp_type == "swiglu" else 2
                total += n * (mult * d * self.d_ff + d)
            elif slot.ffn == "moe":
                e = self.moe_top_k if active_only else (
                    self.moe_experts_held or self.moe_num_experts)
                ff = self.moe_d_ff or self.d_ff
                mult = 3 if self.mlp_type == "swiglu" else 2
                total += n * (d * self.moe_num_experts  # router (always dense)
                              + e * mult * d * ff + d)
        if self.is_encoder_decoder:
            # encoder self-attn + mlp, decoder cross-attn (approx: reuse attn size)
            enc = self.encoder_layers * (
                d * hd * (self.num_heads + 2 * self.num_kv_heads)
                + self.num_heads * hd * d + 2 * d * self.d_ff + 2 * d)
            xattn = self.num_layers * (
                d * hd * (self.num_heads + 2 * self.num_kv_heads)
                + self.num_heads * hd * d + d)
            total += enc + xattn
        total += d  # final norm
        return total

    def flops_per_token(self, seq_len: int, decode: bool = False) -> float:
        """Model FLOPs per token: 6N (+attention term) train, 2N decode."""
        n_active = self.param_count(active_only=True)
        base = (2.0 if decode else 6.0) * n_active
        # attention score FLOPs (per token, against seq_len context)
        attn_ctx = min(seq_len, self.sliding_window) if self.sliding_window else seq_len
        n_attn_layers = sum(1 for s in self.block_pattern() if s.mixer == "attn") \
            * self.num_periods()
        factor = 2.0 if decode else 6.0  # fwd only vs fwd+bwd
        base += factor * 2 * n_attn_layers * self.num_heads * self.resolved_head_dim * attn_ctx
        return base


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)
