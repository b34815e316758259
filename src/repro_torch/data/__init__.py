"""Deterministic synthetic data streams (``data/pipeline.py``)."""
from repro_torch.data.pipeline import (Prefetcher, din_batch_stream,
                                       gnn_epoch_stream, lm_token_stream)

__all__ = ["Prefetcher", "din_batch_stream", "gnn_epoch_stream",
           "lm_token_stream"]
