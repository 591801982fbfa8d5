"""Config for nemotron-4-340b (see repro_torch.configs.all for the single source of truth)."""
from repro_torch.configs.all import NEMOTRON_4_340B

CONFIG = NEMOTRON_4_340B
