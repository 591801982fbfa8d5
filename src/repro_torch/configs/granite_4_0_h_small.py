"""Config for granite-4.0-h-small (see repro_torch.configs.all for the single source of truth)."""
from repro_torch.configs.all import GRANITE_4_0_H_SMALL

CONFIG = GRANITE_4_0_H_SMALL
