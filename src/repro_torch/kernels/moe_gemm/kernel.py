"""ctypes bindings of the CUDA moe_gemm kernels: the forward
(``csrc/moe_gemm.cu``) and its backward (``csrc/moe_gemm_bwd.cu``).

The TPU kernel the forward replaces is ``moe_gemm_pallas``
(``src/repro/kernels/moe_gemm/kernel.py``), which has no backward; each
source's header says what bounds it on the H100 and what its design does
about that.  The libraries are built at first use
(:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gemm.cu"
BWD_SOURCE = SOURCE.with_name("moe_gemm_bwd.cu")
# (dtype, variant) -> the backward's launcher; ops.route_bwd picks it
_BWD_SYMBOLS = {(torch.float32, "simt"): "moe_gemm_bwd_launch_f32",
                (torch.bfloat16, "simt"): "moe_gemm_bwd_launch_bf16",
                (torch.bfloat16, "wgmma"): "moe_gemm_bwd_launch_bf16_wgmma"}
# (dtype, variant) -> the exported launcher; ops.route picks the variant
_SYMBOLS = {(torch.float32, "simt"): "moe_gemm_launch_f32",
            (torch.bfloat16, "simt"): "moe_gemm_launch_bf16",
            (torch.bfloat16, "wgmma"): "moe_gemm_launch_bf16_wgmma",
            (torch.bfloat16, "stream"): "moe_gemm_launch_bf16_stream"}


def _launcher(dtype: torch.dtype, variant: str):
    fn = getattr(build.load(SOURCE), _SYMBOLS[dtype, variant])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def moe_gemm_cuda(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                  wd: torch.Tensor, h: torch.Tensor, out: torch.Tensor,
                  variant: str) -> None:
    """Launch the kernel's ``variant`` on the current stream of ``x``'s
    device: ``h`` (E, C, f) is the scratch the gate/up pass writes and
    the down pass reads, ``out`` (E, C, d).  The caller has checked
    shapes, dtypes, device and contiguity and picked the variant
    (``ops.route``)."""
    E, C, d = x.shape
    f = wg.shape[-1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher(x.dtype, variant)(
            x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            h.data_ptr(), out.data_ptr(), E, C, d, f, stream)
    if err != 0:
        raise RuntimeError(f"moe_gemm kernel launch failed: CUDA error {err} "
                           f"({variant}, E={E}, C={C}, d={d}, f={f}, "
                           f"{x.dtype})")


def moe_gemm_bwd_cuda(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                      wd: torch.Tensor, dy: torch.Tensor, da: torch.Tensor,
                      db: torch.Tensor, h: torch.Tensor, variant: str) -> None:
    """Launch the backward kernel's ``variant`` on the current stream of
    ``x``'s device: from x, dy (E, C, d) and the weights it writes ``da``,
    ``db`` and ``h`` (E, C, f).  The caller has checked shapes, dtypes,
    device and contiguity and picked the variant (``ops.route_bwd``)."""
    E, C, d = x.shape
    f = wg.shape[-1]
    fn = getattr(build.load(BWD_SOURCE), _BWD_SYMBOLS[x.dtype, variant])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (x, wg, wu, wd, dy, da, db, h)),
                 E, C, d, f, stream)
    if err != 0:
        raise RuntimeError(f"moe_gemm_bwd kernel launch failed: CUDA error "
                           f"{err} ({variant}, E={E}, C={C}, d={d}, f={f}, "
                           f"{x.dtype})")
