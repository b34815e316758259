"""Where the port's tensors live.

Every entry point takes ``device=None``, which means the card
(``torch.device("cuda")``).  Without CUDA that raises: the port never
moves to the CPU on its own.  The CPU is used only when a caller asks for
it (the tests pass ``device="cpu"``), and then every kernel wrapper runs
its plain PyTorch version because its tensors lie on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> CUDA; raise if the requested CUDA device is missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
