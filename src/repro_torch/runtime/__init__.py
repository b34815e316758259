"""The fault-tolerant trainer (``runtime/trainer.py``)."""
from repro_torch.runtime.trainer import (FaultInjector, Trainer,
                                         TrainerConfig, deterministic)

__all__ = ["FaultInjector", "Trainer", "TrainerConfig", "deterministic"]
