"""ctypes binding of the CUDA segment_spmm kernels: the "sum" variant and
the fused "gat" variant (``csrc/segment_spmm.cu``), and their gradients,
"sum_bwd" and "gat_bwd" (``csrc/segment_spmm_bwd.cu``); both sources
include ``csrc/segment_spmm.cuh``.

The TPU kernel they replace is ``segment_spmm_pallas``
(``src/repro/kernels/segment_spmm/kernel.py``; it has no backward); each
source's header says what bounds its kernels on the H100 and what their
design does about that.  The libraries are built at first use
(:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_spmm.cu"
BWD_SOURCE = SOURCE.with_name("segment_spmm_bwd.cu")
_ARGTYPES = {
    "segment_spmm_launch": ([ctypes.c_void_p] * 3
                            + [ctypes.c_longlong, ctypes.c_void_p]
                            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                            + [ctypes.c_void_p]),
    "gat_aggregate_launch": ([ctypes.c_void_p] * 6
                             + [ctypes.c_longlong, ctypes.c_void_p,
                                ctypes.c_longlong]
                             + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "segment_spmm_bwd_launch": ([ctypes.c_void_p] * 3
                                + [ctypes.c_longlong, ctypes.c_void_p]
                                + [ctypes.c_longlong] * 2
                                + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
    "gat_bwd_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
}


def _launcher(name: str):
    source = BWD_SOURCE if name.endswith("bwd_launch") else SOURCE
    fn = getattr(build.load(source), name)
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


def segment_spmm_bwd_cuda(dout: torch.Tensor, plan, dmsgs: torch.Tensor
                          ) -> None:
    """Launch "sum_bwd" on the current stream of ``dout``'s device:
    ``dout`` (n, D), ``dmsgs`` (E, D), and the forward's plan (``perm``
    and row ``spans``).  The caller has checked shapes, dtypes, device
    and contiguity."""
    n, d = dout.shape
    with torch.cuda.device(dout.device):
        err = _launcher("segment_spmm_bwd_launch")(
            dout.data_ptr(), plan.perm.data_ptr(), plan.spans.data_ptr(),
            plan.n_heavy, dmsgs.data_ptr(), n, d,
            int(dout.dtype == torch.bfloat16),
            int(dmsgs.dtype == torch.bfloat16), _stream(dout))
    if err != 0:
        raise RuntimeError(f"segment_spmm backward kernel launch failed: "
                           f"CUDA error {err} (E={dmsgs.shape[0]}, n={n}, "
                           f"D={d}, {dout.dtype} -> {dmsgs.dtype})")


def gat_bwd_cuda(hw: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor,
                 plan, plan_by_src, dout: torch.Tensor,
                 acc_dtype: torch.dtype, alpha: torch.Tensor,
                 dsc: torch.Tensor, dhw: torch.Tensor, ds_src: torch.Tensor,
                 ds_dst: torch.Tensor) -> None:
    """Launch "gat_bwd" (its two passes) on the current stream of
    ``hw``'s device: the forward's inputs, its plan and the source plan
    over that plan's edge positions (``ops.source_plan``), ``dout`` (N,
    H, dout), the gradient of the forward's output rounded to hw's
    dtype, the forward's ``acc_dtype``, the (E, H) float32 scratch
    ``alpha`` and ``dsc``, and the gradients ``dhw``, ``ds_src``,
    ``ds_dst`` in hw's dtype.  The caller has checked shapes, dtypes,
    device, contiguity and the kernel's shape limits."""
    n, heads, d = hw.shape
    t = plan_by_src
    with torch.cuda.device(hw.device):
        err = _launcher("gat_bwd_launch")(
            hw.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(),
            plan.src_sorted.data_ptr(), plan.live_sorted.data_ptr(),
            plan.spans.data_ptr(), plan.n_heavy, t.perm.data_ptr(),
            t.src_sorted.data_ptr(), t.live_sorted.data_ptr(),
            t.spans.data_ptr(), t.n_heavy, dout.data_ptr(), alpha.data_ptr(),
            dsc.data_ptr(), dhw.data_ptr(), ds_src.data_ptr(),
            ds_dst.data_ptr(), n, heads, d,
            int(hw.dtype == torch.bfloat16),
            int(acc_dtype == torch.bfloat16), _stream(hw))
    if err != 0:
        raise RuntimeError(f"gat_aggregate backward kernel launch failed: "
                           f"CUDA error {err} (E={plan.n_edges}, n={n}, "
                           f"H={heads}, dout={d}, {hw.dtype}, sums in "
                           f"{acc_dtype})")
