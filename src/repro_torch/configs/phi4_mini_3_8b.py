"""Phi-4-mini 3.8B [arXiv:2412.08905; hf]: RoPE + SwiGLU + GQA.

Deviation (DESIGN.md): partial-RoPE fraction not modelled; standard
full-head RoPE is applied.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4_mini_3_8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    tie_embeddings=True,    # hf: tie_word_embeddings=true -> 3.8B total
)
