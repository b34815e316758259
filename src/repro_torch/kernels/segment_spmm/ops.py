"""segment_spmm entry point: the CUDA kernel on the card, the plain
PyTorch version on the CPU.

``segment_spmm(msgs, dst, n)`` sums edge messages by destination node,
in float32.  On the card the kernel works from a :class:`SegmentPlan`,
the destination-sorted CSR of the edge list, which
:func:`segment_plan` builds once per graph: a forward passes the same
plan to every segment sum it does (``GraphBatch.plan``).

The tensor's device decides the path.  A CUDA tensor launches the
kernel or raises — there is no fallback — and each launch adds one to
:data:`launches`, so a run can show that its main path went through the
kernel.  A CPU tensor runs :func:`segment_spmm_plain`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.kernels.segment_spmm.ref import segment_sum_dense

launches = 0    # kernel launches since the count was last set to 0
DTYPES = (torch.float32, torch.bfloat16)
INDEX_DTYPES = (torch.int32, torch.int64)
MAX_INDEX = 2 ** 31 - 1     # the kernel's edge and node ids are int32


@dataclass(frozen=True)
class SegmentPlan:
    """The destination-sorted CSR of one edge list: destination ``v``
    owns the edges ``perm[rowptr[v]:rowptr[v + 1]]``, in edge order."""

    perm: torch.Tensor      # (E,) int32: edge ids sorted stably by dst
    rowptr: torch.Tensor    # (n + 1,) int32

    @property
    def n(self) -> int:
        return self.rowptr.numel() - 1

    @property
    def n_edges(self) -> int:
        return self.perm.numel()


def segment_plan(dst: torch.Tensor, n: int) -> SegmentPlan:
    """The :class:`SegmentPlan` of ``dst`` (E,) int32/int64 ids in
    ``[0, n)``: a stable sort of the edges by destination and the row
    pointers from a ``bincount`` and a ``cumsum``.  Preprocessing, run
    once per graph; it reads the counts' length, so it waits for the
    device."""
    if dst.dim() != 1 or dst.dtype not in INDEX_DTYPES:
        raise ValueError(f"segment_plan wants dst (E,) int32 or int64, got "
                         f"{tuple(dst.shape)} {dst.dtype}")
    if dst.numel() > MAX_INDEX or not 0 <= n <= MAX_INDEX:
        raise ValueError(f"segment_plan takes E and n below 2**31, got "
                         f"E={dst.numel()}, n={n}")
    counts = torch.bincount(dst, minlength=n)     # raises on ids < 0
    if counts.numel() != n:
        raise ValueError(f"segment_plan: dst holds ids >= n = {n}")
    perm = torch.sort(dst, stable=True).indices.to(torch.int32)
    rowptr = torch.zeros(n + 1, dtype=torch.int32, device=dst.device)
    rowptr[1:] = counts.cumsum(0)
    return SegmentPlan(perm, rowptr)


def _check(msgs: torch.Tensor, dst: torch.Tensor, n: int,
           plan: SegmentPlan | None, out_dtype: torch.dtype) -> None:
    if msgs.dim() < 1 or dst.dim() != 1 or msgs.shape[0] != dst.shape[0]:
        raise ValueError(f"segment_spmm wants msgs (E, ...) and dst (E,), "
                         f"got {tuple(msgs.shape)} and {tuple(dst.shape)}")
    if msgs.dtype not in DTYPES:
        raise TypeError(f"segment_spmm wants float32 or bfloat16 messages, "
                        f"got {msgs.dtype}")
    if out_dtype not in (torch.float32, msgs.dtype):
        raise TypeError(f"segment_spmm writes float32 or the messages' "
                        f"dtype {msgs.dtype}, not {out_dtype}")
    if dst.dtype not in INDEX_DTYPES:
        raise TypeError(f"segment_spmm wants int32 or int64 ids, got "
                        f"{dst.dtype}")
    if dst.device != msgs.device:
        raise ValueError("segment_spmm wants msgs and dst on one device")
    if msgs.shape[0] > MAX_INDEX or not 0 <= n <= MAX_INDEX:
        raise ValueError(f"segment_spmm takes E and n below 2**31, got "
                         f"E={msgs.shape[0]}, n={n}")
    if plan is not None and (plan.n != n or plan.n_edges != msgs.shape[0]
                             or plan.perm.device != msgs.device):
        raise ValueError(f"segment_spmm: the plan (n={plan.n}, "
                         f"E={plan.n_edges}, {plan.perm.device}) does not "
                         f"fit n={n}, E={msgs.shape[0]}, {msgs.device}")


def segment_spmm_plain(msgs: torch.Tensor, dst: torch.Tensor, n: int,
                       plan: SegmentPlan | None = None,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """The plain version of :func:`segment_spmm`, on any device:
    ``index_add_`` into float32 (the plan is checked, not used)."""
    _check(msgs, dst, n, plan, out_dtype)
    E, tail = msgs.shape[0], msgs.shape[1:]
    out = segment_sum_dense(msgs.reshape(E, math.prod(tail)), dst, n)
    return out.to(out_dtype).reshape(n, *tail)


def segment_spmm(msgs: torch.Tensor, dst: torch.Tensor, n: int,
                 plan: SegmentPlan | None = None,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """msgs (E, ...) float32 or bfloat16, dst (E,) ids in ``[0, n)`` ->
    (n, ...) ``out_dtype`` (float32, or the messages' dtype):
    ``out[v] = sum of msgs[e] over the edges e with dst[e] == v``, summed
    in float32; a node with no edge gets 0.  ``plan`` is
    ``segment_plan(dst, n)``, built here when it is not given."""
    global launches
    if msgs.device.type == "cpu":
        return segment_spmm_plain(msgs, dst, n, plan, out_dtype)
    _check(msgs, dst, n, plan, out_dtype)
    if msgs.device.type != "cuda":
        raise ValueError(f"segment_spmm runs on cuda or cpu, not "
                         f"{msgs.device}")
    from repro_torch.kernels.segment_spmm.kernel import segment_spmm_cuda

    if plan is None:
        plan = segment_plan(dst, n)
    E, tail = msgs.shape[0], msgs.shape[1:]
    flat = msgs.reshape(E, math.prod(tail)).contiguous()
    out = torch.empty((n, flat.shape[1]), dtype=out_dtype,
                      device=msgs.device)
    if out.numel():
        segment_spmm_cuda(flat, plan.perm, plan.rowptr, out)
        launches += 1
    return out.reshape(n, *tail)
