"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B]: MoE, 64 experts
top-6, per-expert FFN width 1408."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot_v1_16b_a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    moe_num_experts=64,
    moe_top_k=6,
    moe_d_ff=1408,
)
