"""moe_gemm entry point: the CUDA kernel on the card, the plain PyTorch
version on the CPU.

The tensor's device decides.  A CUDA tensor launches the kernel or
raises — there is no fallback — and each launch adds one to
:data:`launches`, so a run can show that its main path went through the
kernel.  Which of the kernel's variants runs is decided before the
launch by :func:`route`, from dtype, shape and alignment alone, and
counted in :data:`launches_by_variant`: "wgmma" (bf16 prefill on the
tensor cores, TMA-fed), "stream" (bf16 decode, C <= 8, streaming the
weights once) or "simt" (f32 on the CUDA cores, and every other shape).
A CPU tensor runs :func:`moe_gemm_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

launches = 0    # kernel launches since the count was last set to 0
VARIANTS = ("wgmma", "stream", "simt")
launches_by_variant = dict.fromkeys(VARIANTS, 0)   # the same, by variant
DTYPES = (torch.float32, torch.bfloat16)
SMALL_C = 8     # at most this many rows per expert: the decode variant


def route(dtype: torch.dtype, C: int, d: int, f: int, ptrs=()) -> str:
    """The kernel variant for x (E, C, d) and weights of width f, from
    dtype, shape and data pointers alone, never from a launch: bf16 with
    ``C <= 8`` is "stream"; bf16 with ``d % 8 == 0``, ``f % 8 == 0`` and
    every pointer 16-byte aligned (contiguous rows are then too) is
    "wgmma"; everything else, float32 above all, is "simt"."""
    if dtype != torch.bfloat16:
        return "simt"
    if C <= SMALL_C:
        return "stream"
    if d % 8 == 0 and f % 8 == 0 and all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "simt"


def moe_gemm(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
             wd: torch.Tensor) -> torch.Tensor:
    """x (E, C, d); wg/wu (E, d, f); wd (E, f, d) -> (E, C, d): the
    grouped expert SwiGLU FFN over the dispatched buffer (see
    :func:`moe_gemm_ref`)."""
    global launches
    if x.dim() != 3 or wg.dim() != 3:
        raise ValueError(f"moe_gemm wants x (E, C, d) and weights (E, d, f), "
                         f"got {tuple(x.shape)} and {tuple(wg.shape)}")
    E, C, d = x.shape
    f = wg.shape[-1]
    if (tuple(wg.shape) != (E, d, f) or tuple(wu.shape) != (E, d, f)
            or tuple(wd.shape) != (E, f, d)):
        raise ValueError(f"moe_gemm: x {tuple(x.shape)} does not fit wg "
                         f"{tuple(wg.shape)}, wu {tuple(wu.shape)}, wd "
                         f"{tuple(wd.shape)}")
    if x.dtype not in DTYPES or any(w.dtype != x.dtype for w in (wg, wu, wd)):
        raise TypeError(f"moe_gemm wants float32 or bfloat16 of one dtype, "
                        f"got {x.dtype}, {wg.dtype}, {wu.dtype}, {wd.dtype}")
    if any(w.device != x.device for w in (wg, wu, wd)):
        raise ValueError("moe_gemm wants all tensors on one device")
    if x.device.type == "cpu":
        return moe_gemm_ref(x, wg, wu, wd)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gemm runs on cuda or cpu, not {x.device}")
    if E > 65535:
        raise ValueError(f"moe_gemm kernel takes E <= 65535, got {E}")
    from repro_torch.kernels.moe_gemm.kernel import moe_gemm_cuda

    x, wg, wu, wd = (t.contiguous() for t in (x, wg, wu, wd))
    out = torch.empty_like(x)
    if out.numel():
        h = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
        variant = route(x.dtype, C, d, f,
                        [t.data_ptr() for t in (x, wg, wu, wd, h, out)])
        moe_gemm_cuda(x, wg, wu, wd, h, out, variant)
        launches += 1
        launches_by_variant[variant] += 1
    return out
