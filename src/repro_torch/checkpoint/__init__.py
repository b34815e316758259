"""Atomic, optionally asynchronous checkpoints (``checkpoint/checkpoint.py``)."""
from repro_torch.checkpoint.checkpoint import (latest_step, load_checkpoint,
                                               save_checkpoint)

__all__ = ["latest_step", "load_checkpoint", "save_checkpoint"]
