"""Membership entry point: the CUDA kernel on the card, the plain PyTorch
version on the CPU.

The tensor's device decides.  A CUDA tensor launches the kernel or
raises — there is no fallback — and each launch adds one to
:data:`launches`, so a run can show that its main path went through the
kernel.  A CPU tensor runs :func:`membership_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.membership.ref import membership_ref

launches = 0    # kernel launches since the count was last set to 0


def membership(rows: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """rows (B, M) sorted int32 (sentinel-padded); vals (B, K) int32 ->
    (B, K) bool, ``vals[b, k] in rows[b]`` (see :func:`membership_ref`)."""
    global launches
    if rows.dim() != 2 or vals.dim() != 2 or rows.shape[0] != vals.shape[0]:
        raise ValueError(f"membership wants rows (B, M) and vals (B, K), "
                         f"got {tuple(rows.shape)} and {tuple(vals.shape)}")
    if rows.dtype != torch.int32 or vals.dtype != torch.int32:
        raise TypeError(f"membership wants int32 tensors, got {rows.dtype} "
                        f"and {vals.dtype}")
    if rows.shape[1] < 1:
        raise ValueError("membership wants rows with at least one column")
    if rows.device != vals.device:
        raise ValueError(f"rows on {rows.device}, vals on {vals.device}")
    if not (rows.is_contiguous() and vals.is_contiguous()):
        raise ValueError("membership wants contiguous tensors")
    if rows.device.type == "cpu":
        return membership_ref(rows, vals)
    if rows.device.type != "cuda":
        raise ValueError(f"membership runs on cuda or cpu, not {rows.device}")
    from repro_torch.kernels.membership.kernel import membership_cuda

    out = torch.empty(vals.shape, dtype=torch.bool, device=rows.device)
    if out.numel():
        membership_cuda(rows, vals, out)
        launches += 1
    return out
