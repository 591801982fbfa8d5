"""Config for mistral-nemo-12b (see repro_torch.configs.all for the single source of truth)."""
from repro_torch.configs.all import MISTRAL_NEMO_12B

CONFIG = MISTRAL_NEMO_12B
