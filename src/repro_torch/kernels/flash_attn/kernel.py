"""ctypes binding of the CUDA flash-attention kernel
(``csrc/flash_attn.cu``).

The TPU kernel it replaces is ``flash_attention_pallas``
(``src/repro/kernels/flash_attn/kernel.py``); the source's header says
what bounds it on the H100 and what its design does about that.  The
library is built at first use (:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attn.cu"
# (dtype, variant) -> the exported launcher; ops.route picks the variant
_SYMBOLS = {(torch.float32, "simt"): "flash_attn_launch_f32",
            (torch.bfloat16, "simt"): "flash_attn_launch_bf16",
            (torch.bfloat16, "wgmma"): "flash_attn_launch_bf16_wgmma"}


def _launcher(dtype: torch.dtype, variant: str):
    fn = getattr(build.load(SOURCE), _SYMBOLS[dtype, variant])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, causal: bool, q_offset: int,
                    variant: str) -> None:
    """Launch the kernel's ``variant`` on the current stream of ``q``'s
    device.  q (B, Sq, H, D), k/v (B, Skv, Hk, D), out (B, Sq, H, D), all
    contiguous and of one dtype; the caller has checked them and picked
    the variant (``ops.route``)."""
    B, Sq, H, D = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher(q.dtype, variant)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            Hk, Sq, Skv, D, int(causal), q_offset, stream)
    if err != 0:
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error "
                           f"{err} ({variant}, B={B}, Sq={Sq}, Skv={Skv}, "
                           f"H={H}, Hk={Hk}, D={D}, {q.dtype})")
