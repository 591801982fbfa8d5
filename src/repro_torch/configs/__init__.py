"""Architecture config registry."""
from repro_torch.configs.base import (ArchConfig, MLAConfig, MoEConfig, SSMConfig,
                                ShapeConfig, SHAPES, get_arch, list_archs, cells)
from repro_torch.configs.all import ALL_ARCHS  # noqa: F401 (registers everything)
