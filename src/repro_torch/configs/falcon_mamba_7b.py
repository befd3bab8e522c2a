"""Falcon-Mamba-7B [arXiv:2410.05355]: pure Mamba-1, attention-free,
64 layers, ssm_state=16."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon_mamba_7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state_dim=16,
    ssm_expand=2,
    tie_embeddings=True,
)
