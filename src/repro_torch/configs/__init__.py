from repro_torch.configs.base import (
    ALL_SHAPES,
    ARCH_IDS,
    ArchConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    all_cells,
    get_arch,
    get_shape,
)

__all__ = [
    "ALL_SHAPES",
    "ARCH_IDS",
    "ArchConfig",
    "MoEConfig",
    "ShapeConfig",
    "SSMConfig",
    "all_cells",
    "get_arch",
    "get_shape",
]
