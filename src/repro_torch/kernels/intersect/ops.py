"""Intersect entry point: the CUDA kernel on the card, the plain PyTorch
version on the CPU.

The tensor's device decides.  A CUDA tensor launches the kernel or
raises — there is no fallback — and each launch adds one to
:data:`launches`, so a run can show that its main path went through the
kernel, and :data:`shapes` counts the launches by ``(B, M)``.  A CPU
tensor runs :func:`intersect_ref`.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels.intersect.ref import intersect_ref

launches = 0    # kernel launches since the count was last set to 0
shapes: Counter = Counter()   # launches by (B, M), reset with launches


def intersect(a: torch.Tensor, b: torch.Tensor, sentinel: int):
    """a, b (B, M) int32 sentinel-padded windows, ``b`` sorted per row ->
    ``(mask (B, M) bool, count (B,) int32)``: ``a[r, j]`` is in ``b[r]``
    and is not the sentinel (see :func:`intersect_ref`)."""
    global launches
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"intersect wants a and b of one shape (B, M), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"intersect wants int32 tensors, got {a.dtype} and "
                        f"{b.dtype}")
    if a.shape[1] < 1:
        raise ValueError("intersect wants windows of at least one column")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("intersect wants contiguous tensors")
    if a.device.type == "cpu":
        return intersect_ref(a, b, sentinel)
    if a.device.type != "cuda":
        raise ValueError(f"intersect runs on cuda or cpu, not {a.device}")
    from repro_torch.kernels.intersect.kernel import intersect_cuda

    mask = torch.empty(a.shape, dtype=torch.bool, device=a.device)
    count = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    if mask.numel():
        intersect_cuda(a, b, int(sentinel), mask, count)
        launches += 1
        shapes[tuple(a.shape)] += 1
    return mask, count
