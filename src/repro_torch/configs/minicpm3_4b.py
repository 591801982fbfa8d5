"""Config for minicpm3-4b (see repro_torch.configs.all for the single source of truth)."""
from repro_torch.configs.all import MINICPM3_4B

CONFIG = MINICPM3_4B
