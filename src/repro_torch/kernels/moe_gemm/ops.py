"""moe_gemm entry point: the CUDA kernel on the card, the plain PyTorch
version on the CPU.

The tensor's device decides.  A CUDA tensor launches the kernel or
raises — there is no fallback — and each launch adds one to
:data:`launches`, so a run can show that its main path went through the
kernel.  A CPU tensor runs :func:`moe_gemm_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

launches = 0    # kernel launches since the count was last set to 0
DTYPES = (torch.float32, torch.bfloat16)


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
        moe_gemm_cuda(x, wg, wu, wd, h, out)
        launches += 1
    return out
