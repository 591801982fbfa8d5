"""Config for mamba2-130m (see repro_torch.configs.all for the single source of truth)."""
from repro_torch.configs.all import MAMBA2_130M

CONFIG = MAMBA2_130M
