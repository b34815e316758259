"""Collective exchange for the R-Meef engine, and the static-shape
primitives the engine shares (compaction and dedup).

Engine state is *stacked*: every tensor carries a leading ``ndev`` axis,
one entry per virtual machine.  The ``sim`` backend keeps the whole stack
on one device, where the all-to-all ``out[t, s] = x[s, t]`` is an axis
swap.  The byte accounting is the reference's: ``sim`` reports the bytes
a real transport would put on the wire, the diagonal (self-traffic) free.

Only ``sim`` with the ``raw`` wire format is ported in this slice; the
other backends (ROADMAP queue A item 8) and the ``varint`` codecs (item 7)
raise ``NotImplementedError``.

Every primitive works on any leading batch shape (the reference vmaps a
per-device function), keeps every shape static, and never synchronises
with the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def _off_diagonal(m: torch.Tensor) -> torch.Tensor:
    ndev = m.shape[0]
    return m * (1 - torch.eye(ndev, dtype=m.dtype, device=m.device))


@dataclass(frozen=True)
class SimExchange:
    """Single-device reference exchange: the all-to-all is an axis swap.

    ``comm_chunks > 1`` splits each all-to-all into that many positional
    sub-exchanges along the per-peer capacity axis, as the reference
    does; the result is bit-identical."""

    wire_format: str = "raw"
    comm_chunks: int = 1

    def a2a(self, x: torch.Tensor) -> torch.Tensor:
        """x: (ndev_src, ndev_dst, ...) -> out[t, s] = x[s, t]."""
        c = self.comm_chunks
        if c > 1 and x.dim() >= 3 and x.shape[2] >= c \
                and x.shape[2] % c == 0:
            return torch.cat([p.transpose(0, 1)
                              for p in torch.chunk(x, c, dim=2)], dim=2)
        return x.transpose(0, 1)

    def a2a_tree(self, tree: tuple) -> tuple:
        return tuple(self.a2a(x) for x in tree)

    def off_device_bytes(self, counts: torch.Tensor,
                         elem_bytes: float) -> torch.Tensor:
        """Wire bytes implied by a per-peer request count matrix
        (``counts[t, p]`` = entries ``t`` sends to ``p``), as f32."""
        return _off_diagonal(counts).sum().to(torch.float32) * elem_bytes

    def off_device_payload_bytes(self, byte_matrix: torch.Tensor
                                 ) -> torch.Tensor:
        """Like :meth:`off_device_bytes` for pre-summed per-peer byte
        matrices."""
        return _off_diagonal(byte_matrix).sum().to(torch.float32)

    def per_dev_sent_bytes(self, byte_matrix: torch.Tensor) -> torch.Tensor:
        """Per-device off-device sent bytes: row sums with the free
        diagonal masked, ``(ndev,)`` f32."""
        return _off_diagonal(byte_matrix).sum(dim=1).to(torch.float32)

    def register_metrics(self, reg, comm_pipeline: bool | None = None
                         ) -> None:
        """Set the exchange-owned instruments on a stats registry.  One
        process runs every virtual machine."""
        reg["process_index"] = 0
        reg["process_count"] = 1
        reg["comm_pipeline"] = (self.comm_chunks > 1 if comm_pipeline is None
                                else bool(comm_pipeline))
        reg["comm_chunks"] = self.comm_chunks


def Exchange(mode: str = "sim", wire_format: str = "raw",
             comm_chunks: int = 1) -> SimExchange:
    """The exchange backend for ``mode`` (``sim`` only in this slice)."""
    if mode in ("gather", "spmd", "dist"):
        raise NotImplementedError(
            f"exchange mode {mode!r} is not ported yet (ROADMAP queue A "
            f"item 8); use mode='sim'")
    if mode != "sim":
        raise ValueError(f"unknown exchange mode {mode!r}")
    if wire_format == "varint":
        raise NotImplementedError(
            "wire_format='varint' is not ported yet (ROADMAP queue A item 7)")
    if wire_format != "raw":
        raise ValueError(f"unknown wire format {wire_format!r}")
    if not isinstance(comm_chunks, int) or comm_chunks < 1:
        raise ValueError(
            f"comm_chunks must be an int >= 1, got {comm_chunks!r}")
    return SimExchange(wire_format=wire_format, comm_chunks=comm_chunks)


# --------------------------------------------------------------------------- #
# Static-shape primitives (leading batch dims allowed; no host syncs)
# --------------------------------------------------------------------------- #
def row_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 running count of ``mask`` along its last axis.

    Computed as one flat scan minus each row's starting offset: on the
    card, PyTorch scans the last axis of a few long rows with one thread
    block per row, while a 1-D scan uses the whole device."""
    if mask.numel() >= 1 << 31:
        raise ValueError("row_cumsum counts in int32: too many elements")
    flat = torch.cumsum(mask.reshape(-1), dim=0, dtype=torch.int32)
    flat = flat.view(mask.shape)
    ends = flat[..., -1].reshape(-1)
    start = torch.cat([ends.new_zeros(1), ends[:-1]])
    return flat.sub_(start.view(mask.shape[:-1] + (1,)))


def compact_index(mask: torch.Tensor, cap_out: int):
    """Stable compaction plan for ``mask (..., N)`` into ``cap_out`` slots.

    Returns ``(new_mask (..., cap_out), overflow (...), take (..., cap_out)
    int64)``: ``take[..., j]`` is the index of the ``j``-th set entry for
    ``j < count`` (and an arbitrary in-range index beyond it).  The
    reference sorts ``~mask`` stably (an ``O(N log N)`` argsort with int64
    indices); a running count plus a search over it gives the same order
    in ``O(N + cap_out log N)`` and keeps only an int32 count of size N.
    """
    n = mask.shape[-1]
    csum = row_cumsum(mask)
    count = csum[..., -1:]
    j = torch.arange(1, cap_out + 1, dtype=torch.int32, device=mask.device)
    take = torch.searchsorted(csum, j.expand(mask.shape[:-1] + (cap_out,))
                              .contiguous())
    take = take.clamp_(max=n - 1)
    new_mask = j <= count.clamp(max=cap_out)
    return new_mask, count[..., 0] > cap_out, take


def masked(x: torch.Tensor, keep: torch.Tensor, fill) -> torch.Tensor:
    """``x`` where ``keep`` (broadcast over ``x``'s trailing dims), else
    ``fill`` — a Python scalar, so no host value is copied to the device
    (a copy from pageable memory would synchronise the stream)."""
    keep = keep.reshape(keep.shape + (1,) * (x.dim() - keep.dim()))
    return x.masked_fill(~keep, fill)


def compact(mask: torch.Tensor, cap_out: int, *arrays: torch.Tensor,
            fill=0, fills: tuple | None = None) -> tuple:
    """Stable-compact entries where ``mask (..., N)`` is True into
    ``cap_out`` slots.  ``arrays`` are ``(..., N, *tail)`` with the mask's
    leading shape.  Returns ``(new_mask, overflow, *gathered)`` with
    unused slots set to ``fill`` (``fills`` overrides it per array) and
    ``overflow`` per leading index."""
    new_mask, overflow, take = compact_index(mask, cap_out)
    if fills is None:
        fills = (fill,) * len(arrays)
    lead = mask.dim() - 1
    outs = []
    for a, fl in zip(arrays, fills):
        idx = take.reshape(take.shape + (1,) * (a.dim() - lead - 1))
        g = torch.gather(a, lead, idx.expand(take.shape + a.shape[lead + 1:]))
        outs.append(masked(g, new_mask, fl))
    return (new_mask, overflow, *outs)


def unique_ids(ids: torch.Tensor, mask: torch.Tensor, sentinel: int):
    """Sorted-unique of masked ids along the last axis.  Returns
    ``(uids, umask)`` of the input's shape with invalid slots pushed to
    the back as ``sentinel``."""
    x = torch.where(mask, ids, torch.full_like(ids, sentinel))
    xs = torch.sort(x, dim=-1).values
    first = torch.ones_like(mask)
    first[..., 1:] = xs[..., 1:] != xs[..., :-1]
    valid = first & (xs < sentinel)
    umask, _, uids = compact(valid, x.shape[-1], xs, fill=sentinel)
    return uids, umask


def lexsort(keys: tuple) -> torch.Tensor:
    """``numpy.lexsort`` along the last axis (last key primary): chained
    stable sorts, least significant key first."""
    order = torch.argsort(keys[0], dim=-1, stable=True)
    for k in keys[1:]:
        order = order.gather(-1, torch.argsort(k.gather(-1, order), dim=-1,
                                               stable=True))
    return order


def unique_pairs(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                 sentinel: int) -> tuple:
    """Dedup (a, b) pairs along the last axis without 64-bit keys (EVI,
    Def. 5).

    Returns ``(ua, ub, umask, rank)``: the unique pairs sorted
    lexicographically with invalid ones at the back, and for each input
    pair the slot of its unique pair (int32, always a safe index)."""
    av = torch.where(mask, a, torch.full_like(a, sentinel))
    bv = torch.where(mask, b, torch.full_like(b, sentinel))
    order = lexsort((bv, av))
    a_s, b_s = av.gather(-1, order), bv.gather(-1, order)
    first = torch.ones_like(mask)
    first[..., 1:] = ((a_s[..., 1:] != a_s[..., :-1])
                      | (b_s[..., 1:] != b_s[..., :-1]))
    valid_s = first & (a_s < sentinel)
    umask, _, ua, ub = compact(valid_s, a.shape[-1], a_s, b_s,
                               fill=sentinel)
    # only group heads can be valid, so the running count of valid heads is
    # constant inside a group: it is each group's unique slot (the
    # reference's per-group max scatter), clamped at 0 like its zero init
    slot_sorted = (row_cumsum(valid_s) - 1).clamp_(min=0)
    rank = torch.empty_like(slot_sorted).scatter_(-1, order, slot_sorted)
    return ua, ub, umask, rank
