"""The stage-executable store (``runtime/compile_cache.py``) and the
fault-tolerant trainer (``runtime/trainer.py``)."""
from repro_torch.runtime.compile_cache import (StageExecCache, arg_signature,
                                               build_exec_cache,
                                               code_fingerprint,
                                               stage_context)
from repro_torch.runtime.trainer import (FaultInjector, Trainer,
                                         TrainerConfig, deterministic)

__all__ = ["StageExecCache", "arg_signature", "build_exec_cache",
           "code_fingerprint", "stage_context", "FaultInjector", "Trainer",
           "TrainerConfig", "deterministic"]
