"""Deterministic synthetic data streams (``data/pipeline.py``)."""
from repro_torch.data.pipeline import Prefetcher, lm_token_stream

__all__ = ["Prefetcher", "lm_token_stream"]
