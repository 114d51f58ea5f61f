"""Data substrate: deterministic synthetic LM stream + binary shard reader
(the port of the reference's ``data/``)."""
from repro_torch.data.pipeline import (MemmapTokenReader, SyntheticLMStream,
                                       make_batch_iterator)

__all__ = ["SyntheticLMStream", "MemmapTokenReader", "make_batch_iterator"]
