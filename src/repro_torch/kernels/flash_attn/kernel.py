"""ctypes bindings of the CUDA flash-attention kernels: the forward
(``csrc/flash_attn.cu``) and its backward (``csrc/flash_attn_bwd.cu``).

The TPU kernel the forward replaces is ``flash_attention_pallas``
(``src/repro/kernels/flash_attn/kernel.py``), which has no backward; each
source's header says what bounds it on the H100 and what its design does
about that.  The libraries are built at first use
(:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attn.cu"
BWD_SOURCE = SOURCE.with_name("flash_attn_bwd.cu")
# (dtype, variant) -> the exported launcher; ops.route picks the variant
_SYMBOLS = {(torch.float32, "simt"): "flash_attn_launch_f32",
            (torch.bfloat16, "simt"): "flash_attn_launch_bf16",
            (torch.bfloat16, "wgmma"): "flash_attn_launch_bf16_wgmma"}


def _launcher(dtype: torch.dtype, variant: str):
    fn = getattr(build.load(SOURCE), _SYMBOLS[dtype, variant])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, causal: bool, q_offset: int,
                    variant: str, lse: torch.Tensor | None = None) -> None:
    """Launch the kernel's ``variant`` on the current stream of ``q``'s
    device.  q (B, Sq, H, D), k (B, Skv, Hk, D), v (B, Skv, Hk, Dv), out
    (B, Sq, H, Dv), all contiguous and of one dtype; ``lse``, when given,
    (B, H, Sq) float32 receives each row's log-sum-exp.  The caller has
    checked them and picked the variant (``ops.route``)."""
    B, Sq, H, D = q.shape
    Skv, Hk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher(q.dtype, variant)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if lse is None else lse.data_ptr(), B, H, Hk, Sq, Skv, D, Dv,
            int(causal), q_offset, stream)
    if err != 0:
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error "
                           f"{err} ({variant}, B={B}, Sq={Sq}, Skv={Skv}, "
                           f"H={H}, Hk={Hk}, D={D}, Dv={Dv}, {q.dtype})")


# kernel -> (number of pointer arguments, number of int arguments)
_BWD_ARGS = {"delta": (3, 4), "dkdv": (8, 9), "dq": (7, 9)}
_BWD_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _bwd_launcher(dtype: torch.dtype, kernel: str, variant: str):
    suffix = "_wgmma" if variant == "wgmma" else ""
    fn = getattr(build.load(BWD_SOURCE),
                 f"flash_attn_bwd_{kernel}_{_BWD_DTYPES[dtype]}{suffix}")
    if fn.argtypes is None:
        n_ptr, n_int = _BWD_ARGS[kernel]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attn_bwd_cuda(kernel: str, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, delta: torch.Tensor,
                        outs: tuple, causal: bool, q_offset: int,
                        variant: str = "simt") -> None:
    """Launch one backward kernel on the current stream of ``q``'s
    device: "delta" writes ``delta`` (B, H, Sq) f32 from ``o`` and
    ``do``; "dkdv" writes ``outs = (dk, dv)`` and "dq" ``outs = (dq,)``
    from q, k, v, do, lse and delta, through ``variant`` ("simt" or
    "wgmma"; "delta" has one).  q, k, dq, dk are D wide, v, o, do, dv Dv
    wide.  Every tensor is contiguous, q/k/v/o/do and the outputs of one
    dtype; the caller has checked them and picked the variant
    (``ops.route_bwd``)."""
    B, Sq, H, D = q.shape
    Skv, Hk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    ptrs = [t.data_ptr() for t in outs]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = _bwd_launcher(q.dtype, kernel,
                           "simt" if kernel == "delta" else variant)
        if kernel == "delta":
            err = fn(o.data_ptr(), do.data_ptr(), delta.data_ptr(), B, H,
                     Sq, Dv, stream)
        else:
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), *ptrs, B, H, Hk, Sq,
                     Skv, D, Dv, int(causal), q_offset, stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_{kernel} launch failed: CUDA "
                           f"error {err} ({variant}, B={B}, Sq={Sq}, "
                           f"Skv={Skv}, H={H}, Hk={Hk}, D={D}, Dv={Dv}, "
                           f"{q.dtype})")
