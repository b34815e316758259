"""Deterministic synthetic data streams (``data/pipeline.py``)."""
from repro_torch.data.pipeline import (Prefetcher, gnn_epoch_stream,
                                       lm_token_stream)

__all__ = ["Prefetcher", "gnn_epoch_stream", "lm_token_stream"]
