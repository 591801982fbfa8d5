"""Config for qwen2-vl-2b (see repro_torch.configs.all for the single source of truth)."""
from repro_torch.configs.all import QWEN2_VL_2B

CONFIG = QWEN2_VL_2B
