"""ctypes binding of the CUDA segment_spmm kernel
(``csrc/segment_spmm.cu``).

The TPU kernel it replaces is ``segment_spmm_pallas``
(``src/repro/kernels/segment_spmm/kernel.py``); the source's header says
what bounds it on the H100 and what its design does about that.  The
library is built at first use (:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_spmm.cu"


def _launcher():
    fn = build.load(SOURCE).segment_spmm_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def segment_spmm_cuda(msgs: torch.Tensor, perm: torch.Tensor,
                      rowptr: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the kernel on the current stream of ``msgs``' device:
    ``msgs`` (E, D), ``perm`` (E,) and ``rowptr`` (n + 1,) int32 of the
    plan, ``out`` (n, D).  The caller has checked shapes, dtypes, device
    and contiguity."""
    n, d = out.shape
    with torch.cuda.device(msgs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(msgs.data_ptr(), perm.data_ptr(),
                          rowptr.data_ptr(), out.data_ptr(), n, d,
                          int(msgs.dtype == torch.bfloat16),
                          int(out.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"segment_spmm kernel launch failed: CUDA error "
                           f"{err} (E={msgs.shape[0]}, n={n}, D={d}, "
                           f"{msgs.dtype} -> {out.dtype})")
