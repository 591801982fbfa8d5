"""The LM zoo's decoder in PyTorch (families gqa, hybrid and none)."""
from repro_torch.models import convert, layers, transformer
from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                            init_params)
