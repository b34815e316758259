"""delta_vlen entry point: the CUDA kernel on the card, the plain PyTorch
version on the CPU.

The tensor's device decides.  A CUDA tensor launches the kernel or
raises — there is no fallback — and each launch adds one to
:data:`launches`, so a run can show that its main path went through the
kernel.  A CPU tensor runs :func:`delta_vlen_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.varint.ref import delta_vlen_ref

launches = 0    # kernel launches since the count was last set to 0


def delta_vlen(ids: torch.Tensor, sentinel: int):
    """ids (B, M) int32, ascending among the valid (< sentinel) entries ->
    ``(delta (B, M) int32, vlen (B, M) int32)`` (see
    :mod:`repro_torch.kernels.varint.ref`)."""
    global launches
    if ids.dim() != 2:
        raise ValueError(f"delta_vlen wants ids (B, M), got "
                         f"{tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"delta_vlen wants int32 ids, got {ids.dtype}")
    if not ids.is_contiguous():
        raise ValueError("delta_vlen wants a contiguous tensor")
    if ids.device.type == "cpu":
        return delta_vlen_ref(ids, sentinel)
    if ids.device.type != "cuda":
        raise ValueError(f"delta_vlen runs on cuda or cpu, not {ids.device}")
    from repro_torch.kernels.varint.kernel import delta_vlen_cuda

    delta = torch.empty_like(ids)
    vlen = torch.empty_like(ids)
    if ids.numel():
        delta_vlen_cuda(ids, int(sentinel), delta, vlen)
        launches += 1
    return delta, vlen
