"""Optimizers and int8 gradient compression over pytrees of tensors,
ported beside ``repro.optim``."""
from repro_torch.optim.compression import (compressed_psum, int8_compress,
                                           int8_decompress,
                                           tree_compressed_psum)
from repro_torch.optim.optimizers import (adafactor, adamw,
                                          clip_by_global_norm,
                                          cosine_schedule, make_optimizer)

__all__ = ["adamw", "adafactor", "make_optimizer",
           "clip_by_global_norm", "cosine_schedule", "int8_compress",
           "int8_decompress", "compressed_psum", "tree_compressed_psum"]
