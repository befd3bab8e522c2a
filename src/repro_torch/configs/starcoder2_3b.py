"""StarCoder2-3B [arXiv:2402.19173; hf]: dense GQA decoder, RoPE."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2_3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    rope_theta=1e5,
    mlp_type="gelu",        # starcoder2 uses a standard 2-matrix GELU FFN
    norm_type="layernorm",
    tie_embeddings=True,    # hf: tie_word_embeddings=true -> 3.0B total
)
