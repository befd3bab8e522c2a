"""Minitron-8B (pruned Nemotron) [arXiv:2407.14679; hf]: dense GQA decoder."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron_8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    mlp_type="gelu",        # nemotron squared-ReLU FFN: 2-matrix structure
)
