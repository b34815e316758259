"""ctypes binding of the CUDA segment_spmm kernels
(``csrc/segment_spmm.cu``): the "sum" variant and the fused "gat"
variant.

The TPU kernel they replace is ``segment_spmm_pallas``
(``src/repro/kernels/segment_spmm/kernel.py``); the source's header says
what bounds them on the H100 and what their design does about that.
The library is built at first use (:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_spmm.cu"
_ARGTYPES = {
    "segment_spmm_launch": ([ctypes.c_void_p] * 3
                            + [ctypes.c_longlong, ctypes.c_void_p]
                            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                            + [ctypes.c_void_p]),
    "gat_aggregate_launch": ([ctypes.c_void_p] * 6
                             + [ctypes.c_longlong, ctypes.c_void_p,
                                ctypes.c_longlong]
                             + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
}


def _launcher(name: str):
    fn = getattr(build.load(SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def segment_spmm_cuda(msgs: torch.Tensor, plan, out: torch.Tensor) -> None:
    """Launch "sum" on the current stream of ``msgs``' device: ``msgs``
    (E, D), ``out`` (n, D), and the plan's ``perm`` and row ``spans``.
    The caller has checked shapes, dtypes, device and contiguity."""
    n, d = out.shape
    with torch.cuda.device(msgs.device):
        err = _launcher("segment_spmm_launch")(
            msgs.data_ptr(), plan.perm.data_ptr(), plan.spans.data_ptr(),
            plan.n_heavy, out.data_ptr(), n, d,
            int(msgs.dtype == torch.bfloat16),
            int(out.dtype == torch.bfloat16), _stream(msgs))
    if err != 0:
        raise RuntimeError(f"segment_spmm kernel launch failed: CUDA error "
                           f"{err} (E={msgs.shape[0]}, n={n}, D={d}, "
                           f"{msgs.dtype} -> {out.dtype})")


def gat_aggregate_cuda(hw: torch.Tensor, s_src: torch.Tensor,
                       s_dst: torch.Tensor, plan, out: torch.Tensor) -> None:
    """Launch "gat" on the current stream of ``hw``'s device: ``hw`` (N,
    H, dout), ``s_src`` and ``s_dst`` (N, H) of one dtype, ``out`` (N, H,
    dout), and the plan's ``src_sorted``, ``live_sorted`` and row
    ``spans``.  The caller has checked shapes, dtypes, device, contiguity
    and the kernel's shape limits."""
    n, heads, dout = hw.shape
    with torch.cuda.device(hw.device):
        err = _launcher("gat_aggregate_launch")(
            hw.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(),
            plan.src_sorted.data_ptr(), plan.live_sorted.data_ptr(),
            plan.spans.data_ptr(), plan.n_heavy, out.data_ptr(), n, heads,
            dout, int(hw.dtype == torch.bfloat16),
            int(out.dtype == torch.bfloat16), _stream(hw))
    if err != 0:
        raise RuntimeError(f"gat_aggregate kernel launch failed: CUDA error "
                           f"{err} (E={plan.n_edges}, n={n}, H={heads}, "
                           f"dout={dout}, {hw.dtype} -> {out.dtype})")
