"""Jamba v0.1 52B [arXiv:2403.19887; hf]: hybrid Mamba+attention (1:7
interleave, attention at period-8 offset 4) with MoE (16 experts, top-2)
on every other layer."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba_v0_1_52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    moe_num_experts=16,
    moe_top_k=2,
    moe_period=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=4,
    ssm_state_dim=16,
)
