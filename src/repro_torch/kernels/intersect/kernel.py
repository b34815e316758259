"""ctypes binding of the CUDA intersect kernel (``csrc/intersect.cu``).

The TPU kernel it replaces is ``intersect_pallas``
(``src/repro/kernels/intersect/kernel.py``); the source's header says
what bounds it on the H100 and what its design does about that.  The
library is built at first use (:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "intersect.cu"


def _launcher():
    fn = build.load(SOURCE).intersect_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def intersect_cuda(a: torch.Tensor, b: torch.Tensor, sentinel: int,
                   mask: torch.Tensor, count: torch.Tensor) -> None:
    """Launch the kernel on the current stream of ``a``'s device; it writes
    every element of ``mask`` and ``count``.  The caller has checked
    shapes, dtypes, device and contiguity."""
    B, M = a.shape
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(a.data_ptr(), b.data_ptr(), mask.data_ptr(),
                          count.data_ptr(), B, M, sentinel, stream)
    if err != 0:
        raise RuntimeError(f"intersect kernel launch failed: CUDA error "
                           f"{err} (B={B}, M={M})")
