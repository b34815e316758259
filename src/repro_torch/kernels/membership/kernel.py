"""ctypes binding of the CUDA membership kernel (``csrc/membership.cu``).

The TPU kernel it replaces is ``membership_pallas``
(``src/repro/kernels/membership/kernel.py``); the source's header says
what bounds it on the H100 and what its design does about that.  The
library is built at first use (:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "membership.cu"


def _launcher():
    fn = build.load(SOURCE).membership_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def membership_cuda(rows: torch.Tensor, vals: torch.Tensor,
                    out: torch.Tensor) -> None:
    """Launch the kernel on the current stream of ``rows``' device.  The
    caller has checked shapes, dtypes, device and contiguity."""
    B, M = rows.shape
    K = vals.shape[1]
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(rows.data_ptr(), vals.data_ptr(), out.data_ptr(),
                          B, M, K, stream)
    if err != 0:
        raise RuntimeError(f"membership kernel launch failed: CUDA error "
                           f"{err} (B={B}, M={M}, K={K})")
