"""Config for internlm2-1.8b (see repro_torch.configs.all for the single source of truth)."""
from repro_torch.configs.all import INTERNLM2_1_8B

CONFIG = INTERNLM2_1_8B
