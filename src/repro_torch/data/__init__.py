from repro_torch.data.pipeline import (SyntheticLMDataset, TokenBatcher,
                                       make_batch_iterator)

__all__ = ["SyntheticLMDataset", "TokenBatcher", "make_batch_iterator"]
