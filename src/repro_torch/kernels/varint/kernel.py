"""ctypes binding of the CUDA delta_vlen kernel (``csrc/delta_vlen.cu``).

The TPU kernel it replaces is ``delta_vlen_pallas``
(``src/repro/kernels/varint/kernel.py``); the source's header says what
bounds it on the H100 and what its design does about that.  The library
is built at first use (:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "delta_vlen.cu"


def _launcher():
    fn = build.load(SOURCE).delta_vlen_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def delta_vlen_cuda(ids: torch.Tensor, sentinel: int, delta: torch.Tensor,
                    vlen: torch.Tensor) -> None:
    """Launch the kernel on the current stream of ``ids``' device.  The
    caller has checked shape, dtype, device and contiguity."""
    B, M = ids.shape
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(ids.data_ptr(), delta.data_ptr(), vlen.data_ptr(),
                          B, M, sentinel, stream)
    if err != 0:
        raise RuntimeError(f"delta_vlen kernel launch failed: CUDA error "
                           f"{err} (B={B}, M={M})")
