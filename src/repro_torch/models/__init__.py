"""Model code of the PyTorch port: the dense decoder-only stack (the SSM,
MoE and encoder-decoder families come with later slices)."""
from repro_torch.models.config import BlockSlot, ModelConfig
from repro_torch.models import kvcache, layers, sampling, transformer

__all__ = ["ModelConfig", "BlockSlot", "transformer", "layers", "kvcache",
           "sampling"]
