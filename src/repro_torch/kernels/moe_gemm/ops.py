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
A CPU tensor runs :func:`moe_gemm_ref`, and so does a tensor on the
``meta`` device (a shape check, no data), which launches nothing.

Training goes through :class:`MoeGemm`, a ``torch.autograd.Function``
(:func:`moe_gemm_ad` applies it when an input needs a gradient): its
forward is :func:`moe_gemm`, its backward :func:`moe_gemm_bwd_k`, which on
the card launches ``csrc/moe_gemm_bwd.cu`` (counted in
:data:`bwd_launches` and, by the variant :func:`route_bwd` picks, "wgmma"
or "simt", in :data:`bwd_launches_by_variant`) for da, db and h and leaves
the four weight-sized products to ``torch.bmm``, and on the CPU runs
:func:`moe_gemm_bwd_ref`.
Both are looked up when the Function runs, so a caller that swaps them
for their plain versions swaps the training path too.
"""
from __future__ import annotations

import torch

from repro_torch.device import PLAIN_DEVICES
from repro_torch.kernels.moe_gemm.ref import moe_gemm_bwd_ref, moe_gemm_ref

launches = 0    # kernel launches since the count was last set to 0
VARIANTS = ("wgmma", "stream", "simt")
launches_by_variant = dict.fromkeys(VARIANTS, 0)   # the same, by variant
BWD_VARIANTS = ("wgmma", "simt")
bwd_launches = 0    # backward kernel launches, counted the same way
bwd_launches_by_variant = dict.fromkeys(BWD_VARIANTS, 0)
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


def route_bwd(dtype: torch.dtype, d: int, f: int, ptrs=()) -> str:
    """The backward kernel's variant, from dtype, shape and data pointers
    alone: bf16 with ``d`` and ``f`` positive multiples of 8 and every
    pointer 16-byte aligned is "wgmma" (the tensor cores, TMA-fed);
    everything else, float32 above all, is "simt"."""
    if (dtype == torch.bfloat16 and d > 0 and d % 8 == 0 and f % 8 == 0
            and all(p % 16 == 0 for p in ptrs)):
        return "wgmma"
    return "simt"


def _check(x, wg, wu, wd):
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
    if x.device.type not in ("cuda", *PLAIN_DEVICES):
        raise ValueError(f"moe_gemm runs on cuda, cpu or meta, not "
                         f"{x.device}")
    if x.device.type == "cuda" and x.shape[0] > 65535:
        raise ValueError(f"moe_gemm kernels take E <= 65535, got "
                         f"{x.shape[0]}")


def moe_gemm(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
             wd: torch.Tensor) -> torch.Tensor:
    """x (E, C, d); wg/wu (E, d, f); wd (E, f, d) -> (E, C, d): the
    grouped expert SwiGLU FFN over the dispatched buffer (see
    :func:`moe_gemm_ref`)."""
    global launches
    _check(x, wg, wu, wd)
    E, C, d = x.shape
    f = wg.shape[-1]
    if x.device.type in PLAIN_DEVICES:
        return moe_gemm_ref(x, wg, wu, wd)
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


def moe_gemm_bwd_k(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                   wd: torch.Tensor, dy: torch.Tensor):
    """The gradient of :func:`moe_gemm` for the output gradient ``dy``
    (E, C, d): ``(dx, dwg, dwu, dwd)`` in x's dtype.  A CUDA tensor
    launches the backward kernel for da, db and h (E, C, f), then
    dwd = h^T dy, dx = da wg^T + db wu^T, dwg = x^T da and dwu = x^T db
    as ``torch.bmm``; a CPU tensor runs :func:`moe_gemm_bwd_ref`."""
    global bwd_launches
    _check(x, wg, wu, wd)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"moe_gemm_bwd_k: dy {tuple(dy.shape)} {dy.dtype} "
                         f"does not fit x {tuple(x.shape)} {x.dtype}")
    if x.device.type in PLAIN_DEVICES:
        return moe_gemm_bwd_ref(x, wg, wu, wd, dy)
    from repro_torch.kernels.moe_gemm.kernel import moe_gemm_bwd_cuda

    x, wg, wu, wd, dy = (t.contiguous() for t in (x, wg, wu, wd, dy))
    E, C, d = x.shape
    f = wg.shape[-1]
    da, db, h = (torch.empty((E, C, f), dtype=x.dtype, device=x.device)
                 for _ in range(3))
    if da.numel():
        variant = route_bwd(x.dtype, d, f, [t.data_ptr() for t in
                                            (x, wg, wu, wd, dy, da, db, h)])
        moe_gemm_bwd_cuda(x, wg, wu, wd, dy, da, db, h, variant)
        bwd_launches += 1
        bwd_launches_by_variant[variant] += 1
    dwd = torch.bmm(h.transpose(1, 2), dy)
    dx = torch.bmm(da, wg.transpose(1, 2))
    dx.baddbmm_(db, wu.transpose(1, 2))
    dwg = torch.bmm(x.transpose(1, 2), da)
    dwu = torch.bmm(x.transpose(1, 2), db)
    return dx, dwg, dwu, dwd


class MoeGemm(torch.autograd.Function):
    """Differentiable :func:`moe_gemm`: the forward saves x and the
    weights (h is recomputed by the backward kernel); the backward is
    :func:`moe_gemm_bwd_k`."""

    @staticmethod
    def forward(ctx, x, wg, wu, wd):
        ctx.save_for_backward(x, wg, wu, wd)
        return moe_gemm(x, wg, wu, wd)

    @staticmethod
    def backward(ctx, dy):
        return moe_gemm_bwd_k(*ctx.saved_tensors, dy.contiguous())


def moe_gemm_ad(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """:func:`moe_gemm`, differentiable: through :class:`MoeGemm` when
    gradients are on and an input requires one, else the plain call."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, wg, wu, wd)):
        return MoeGemm.apply(x, wg, wu, wd)
    return moe_gemm(x, wg, wu, wd)
