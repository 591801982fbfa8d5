"""Config for qwen3-moe-235b-a22b (see repro_torch.configs.all for the single source of truth)."""
from repro_torch.configs.all import QWEN3_MOE_235B

CONFIG = QWEN3_MOE_235B
