from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ShapeSpec,
    applicable_shapes,
    get_config,
    smoke_config,
)

__all__ = ["ARCH_IDS", "SHAPES", "ShapeSpec", "applicable_shapes",
           "get_config", "smoke_config"]
