"""Qwen2-VL-2B [arXiv:2409.12191; hf]: VLM backbone with M-RoPE.

The vision/patch frontend is a STUB: input_specs() provides M-RoPE position
triples (and optional patch embeddings); the backbone is a GQA decoder with
3-section rotary (temporal/height/width = 16/24/24 over the 64-dim half)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_vl_2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    tie_embeddings=True,
)
