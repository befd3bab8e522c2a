"""Mixtral 8x22B [arXiv:2401.04088; hf]: MoE 8 experts top-2, sliding-window
attention (window 32768)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral_8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    moe_num_experts=8,
    moe_top_k=2,
    moe_d_ff=16384,
    sliding_window=32768,
    rope_theta=1e6,
)
