"""Optimizers over pytrees of tensors, ported beside ``repro.optim``.
The int8 error-feedback gradient compression (``repro.optim.compression``)
is not ported yet."""
from repro_torch.optim.optimizers import (adafactor, adamw,
                                          clip_by_global_norm,
                                          cosine_schedule, make_optimizer)

__all__ = ["adamw", "adafactor", "make_optimizer",
           "clip_by_global_norm", "cosine_schedule"]
