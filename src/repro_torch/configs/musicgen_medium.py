"""Config for musicgen-medium (see repro_torch.configs.all for the single source of truth)."""
from repro_torch.configs.all import MUSICGEN_MEDIUM

CONFIG = MUSICGEN_MEDIUM
