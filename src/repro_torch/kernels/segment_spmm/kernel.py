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
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "segment_spmm_launch": [_P] * 3 + [_L, _P] + [_L] * 2 + [_I] * 2 + [_P],
    "gat_aggregate_launch": ([_P] * 6 + [_L] + [_P] * 3 + [_L] + [_I] * 4
                             + [_P]),
    "segment_spmm_bwd_launch": ([_P] * 3 + [_L, _P] + [_L] * 2 + [_I] * 2
                                + [_P]),
    "gat_bwd_launch": ([_P] * 8 + [_L] + [_P] * 4 + [_L] + [_P] * 6 + [_L]
                       + [_I] * 4 + [_P]),
}
_fns: dict = {}


def _launcher(name: str):
    """The C entry ``name`` with its argument types, loaded (and built)
    at its first call and kept."""
    fn = _fns.get(name)
    if fn is None:
        source = BWD_SOURCE if name.endswith("bwd_launch") else SOURCE
        fn = getattr(build.load(source), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name: str, t: torch.Tensor, *args) -> int:
    """Call the C entry ``name`` with ``args`` and the current stream of
    ``t``'s device, made the current device first where it is not.  The
    raw stream handle is read without building a ``torch.cuda.Stream``:
    at GraphCast's Cora-sized shapes a call's host time is its cost."""
    dev = t.get_device()
    if dev == torch._C._cuda_getDevice():
        return _launcher(name)(*args, torch._C._cuda_getCurrentRawStream(dev))
    with torch.cuda.device(dev):
        return _launcher(name)(*args, torch._C._cuda_getCurrentRawStream(dev))


def segment_spmm_cuda(msgs: torch.Tensor, plan, out: torch.Tensor) -> None:
    """Launch "sum" on the current stream of ``msgs``' device: ``msgs``
    (E, D), ``out`` (n, D), and the plan's ``perm`` and row ``spans``.
    The caller has checked shapes, dtypes, device and contiguity."""
    n, d = out.shape
    err = _launch("segment_spmm_launch", msgs,
                  msgs.data_ptr(), plan.perm.data_ptr(),
                  plan.spans.data_ptr(), plan.n_heavy, out.data_ptr(), n, d,
                  int(msgs.dtype == torch.bfloat16),
                  int(out.dtype == torch.bfloat16))
    if err != 0:
        raise RuntimeError(f"segment_spmm kernel launch failed: CUDA error "
                           f"{err} (E={msgs.shape[0]}, n={n}, D={d}, "
                           f"{msgs.dtype} -> {out.dtype})")


def gat_aggregate_cuda(hw: torch.Tensor, s_src: torch.Tensor,
                       s_dst: torch.Tensor, plan, out: torch.Tensor,
                       m: torch.Tensor | None = None,
                       den: torch.Tensor | None = None) -> None:
    """Launch "gat" on the current stream of ``hw``'s device: ``hw`` (N,
    H, dout), ``s_src`` and ``s_dst`` (N, H) of one dtype, ``out`` (N, H,
    dout), and the plan's ``src_sorted``, ``live_sorted`` and row
    ``spans``; with ``m`` and ``den`` (N, H) float32, it also writes each
    row's max score and clamped denominator there.  The caller has
    checked shapes, dtypes, device, contiguity and the kernel's shape
    limits."""
    n, heads, dout = hw.shape
    err = _launch("gat_aggregate_launch", hw,
                  hw.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(),
                  plan.src_sorted.data_ptr(), plan.live_sorted.data_ptr(),
                  plan.spans.data_ptr(), plan.n_heavy, out.data_ptr(),
                  None if m is None else m.data_ptr(),
                  None if den is None else den.data_ptr(), n, heads, dout,
                  int(hw.dtype == torch.bfloat16),
                  int(out.dtype == torch.bfloat16))
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
    err = _launch("segment_spmm_bwd_launch", dout,
                  dout.data_ptr(), plan.perm.data_ptr(),
                  plan.spans.data_ptr(), plan.n_heavy, dmsgs.data_ptr(), n,
                  d, dout.dtype is torch.bfloat16,
                  dmsgs.dtype is torch.bfloat16)
    if err != 0:
        raise RuntimeError(f"segment_spmm backward kernel launch failed: "
                           f"CUDA error {err} (E={dmsgs.shape[0]}, n={n}, "
                           f"D={d}, {dout.dtype} -> {dmsgs.dtype})")


def gat_bwd_cuda(hw: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor,
                 m: torch.Tensor, den: torch.Tensor, out: torch.Tensor,
                 dout: torch.Tensor, plan, plan_by_src, rec: torch.Tensor,
                 dout_td: torch.Tensor | None, da: torch.Tensor,
                 dhw: torch.Tensor, ds_src: torch.Tensor,
                 ds_dst: torch.Tensor) -> None:
    """Launch "gat_bwd" (its three kernels) on the current stream of
    ``hw``'s device: the forward's inputs, its saved ``m`` and ``den``
    (N, H) float32 and its output ``out`` (N, H, dout), ``dout`` the
    gradient of ``out`` (its dtype), the forward's plan and the source
    plan over that plan's edge positions (``ops.source_plan``); scratch
    ``rec`` (N, H, 4) float32, ``dout_td`` (hw's shape and dtype, read
    only for a bfloat16 hw with a float32 ``out``), ``da`` (E, H)
    float32; the gradients ``dhw``, ``ds_src``, ``ds_dst`` in hw's dtype.
    The caller has checked shapes, dtypes, device, contiguity and the
    kernel's shape limits."""
    n, heads, d = hw.shape
    t = plan_by_src
    err = _launch("gat_bwd_launch", hw,
                  hw.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(),
                  m.data_ptr(), den.data_ptr(), out.data_ptr(),
                  dout.data_ptr(), plan.spans.data_ptr(), plan.n_heavy,
                  t.perm.data_ptr(), t.src_sorted.data_ptr(),
                  t.live_sorted.data_ptr(), t.spans.data_ptr(), t.n_heavy,
                  rec.data_ptr(),
                  None if dout_td is None else dout_td.data_ptr(),
                  da.data_ptr(), dhw.data_ptr(), ds_src.data_ptr(),
                  ds_dst.data_ptr(), n, heads, d,
                  int(hw.dtype == torch.bfloat16),
                  int(out.dtype == torch.bfloat16))
    if err != 0:
        raise RuntimeError(f"gat_aggregate backward kernel launch failed: "
                           f"CUDA error {err} (E={plan.n_edges}, n={n}, "
                           f"H={heads}, dout={d}, {hw.dtype}, sums in "
                           f"{out.dtype})")
