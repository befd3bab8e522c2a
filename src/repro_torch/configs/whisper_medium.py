"""Whisper-medium [arXiv:2212.04356]: encoder-decoder audio backbone.

The conv/mel frontend is a STUB: input_specs() provides precomputed frame
embeddings [B, 1500, d]. Deviations (DESIGN.md): vocab padded 51865 -> 51968
for sharding (excess logits masked); sinusoidal positions on both stacks.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper_medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51968,
    logical_vocab_size=51865,
    is_encoder_decoder=True,
    encoder_layers=24,
    encoder_seq=1500,
    mlp_type="gelu",
    norm_type="layernorm",
    tie_embeddings=True,
)
