"""Config for arctic-480b (see repro_torch.configs.all for the single source of truth)."""
from repro_torch.configs.all import ARCTIC_480B

CONFIG = ARCTIC_480B
