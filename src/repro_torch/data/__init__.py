from repro_torch.data.pipeline import (SyntheticLMDataset, batch_iterator,
                                 make_batch_for)

__all__ = ["SyntheticLMDataset", "batch_iterator", "make_batch_for"]
