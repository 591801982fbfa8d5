"""Config for hymba-1.5b (see repro_torch.configs.all for the single source of truth)."""
from repro_torch.configs.all import HYMBA_1_5B

CONFIG = HYMBA_1_5B
