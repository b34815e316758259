"""Collective exchange for the R-Meef engine, and the static-shape
primitives the engine shares (compaction and dedup).

Engine state is *stacked*: every tensor carries a leading axis of the
machines (the partitions) this process holds.  A backend supplies the two
collectives the engine needs, ``a2a`` (the batched fetchV/verifyE
request/response routing, ``out[t, s] = x[s, t]``) and ``all_reduce_sum``,
plus the off-device byte accounting that keeps ``stats["bytes_*"]``
comparable across backends: every backend reports the bytes a real
transport would put on the wire, the diagonal (self-traffic) free.

Built-in backends, selected with ``Exchange(mode)``:

* ``sim``    — every machine in this process, the a2a is an axis swap.
               Bit-exact reference semantics for tests.
* ``gather`` — the same protocol through per-destination gathers
               (destination ``t`` takes column ``t`` of every source);
               bit-identical to ``sim``.
* ``spmd``   — one process per machine over ``torch.distributed``: a rank
               holds only machine ``rank``'s slice of the stack (the block
               ``[rank, rank + 1)``), and an a2a is a real
               ``all_to_all_single`` between the processes.
* ``dist``   — ``spmd`` under the reference's name for its
               multi-process path.  Under both, ``whole_stack`` is False:
               the driver pins ``pipeline_depth="auto"`` and the fetch
               answers as one responder.

PyTorch has no single-process multi-device SPMD program, so ``spmd`` here
*is* one process per partition: where the reference's ``spmd`` shards the
stack over a mesh of one process's devices, the port's runs the ranks of a
``torch.distributed`` process group.  This is a deliberate difference,
not a gap; ``spmd`` and ``dist`` share every line of transport.

The process group must be initialized before the run, with one rank per
partition (``world_size == ndev``); :mod:`repro_torch.launch.dist_worker`
does it.  Every rank runs the same program on the same partition and
makes the same host decisions (the finalize is replicated), so every rank
dispatches the same collectives in the same order.  gloo (the default)
moves CUDA tensors too, so two ranks can share one card; NCCL needs a card
per rank.  Bool buffers cross as uint8.

Every backend carries a **wire format** (``raw`` int32 slabs or the
``varint`` codecs of :mod:`repro_torch.core.wire`) and ``comm_chunks``:
``comm_chunks > 1`` splits each a2a into that many positional
sub-exchanges along the per-peer capacity axis (axis 2), whose
concatenation is bit-identical to the whole exchange.

Every primitive works on any leading batch shape (the reference vmaps a
per-device function), keeps every shape static, and never synchronises
with the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch
import torch.distributed as dist


def _off_diagonal(m: torch.Tensor) -> torch.Tensor:
    """Square per-peer matrix ``m`` with its self-traffic zeroed.  The byte
    methods take every machine's rows (``gather_rows`` comes first): a
    block of rows would be masked at the wrong offset, so it raises."""
    ndev = m.shape[0]
    if m.dim() != 2 or m.shape[1] != ndev:
        raise ValueError(f"byte stats take the gathered (ndev, ndev) "
                         f"matrix, got {tuple(m.shape)}")
    return m * (1 - torch.eye(ndev, dtype=m.dtype, device=m.device))


# --------------------------------------------------------------------------- #
# Backend registry
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ExchangeBackend:
    """Base class: collectives over the stacked ``(nloc, ndev, ...)``
    layout, ``nloc`` the machines this process holds."""

    mode: ClassVar[str] = "abstract"
    # every machine's rows are in this process: an a2a over a slice of the
    # responders (a chunk of the leading axis) is still a transpose
    whole_stack: ClassVar[bool] = True

    wire_format: str = "raw"
    comm_chunks: int = 1

    def block(self, ndev: int) -> tuple[int, int]:
        """``(dev0, nloc)``: the machines ``dev0 .. dev0 + nloc - 1`` of
        ``ndev`` whose slice of the stack this process holds."""
        return 0, ndev

    def a2a(self, x: torch.Tensor) -> torch.Tensor:
        """x: (ndev_src, ndev_dst, ...) -> out[t, s] = x[s, t], split into
        ``comm_chunks`` sub-exchanges along axis 2 where it divides
        evenly (2-D length matrices go in one shot)."""
        c = self.comm_chunks
        if c > 1 and x.dim() >= 3 and x.shape[2] >= c \
                and x.shape[2] % c == 0:
            return torch.cat([self._a2a(p) for p in torch.chunk(x, c, dim=2)],
                             dim=2)
        return self._a2a(x)

    def _a2a(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def a2a_tree(self, tree: tuple) -> tuple:
        """``a2a`` over a tuple of buffers, in order."""
        return tuple(self.a2a(x) for x in tree)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x: (nloc, ...) -> the sum over every machine, on each row."""
        raise NotImplementedError

    def gather_rows(self, *mats: torch.Tensor) -> tuple:
        """Per-peer integer matrices ``(nloc, ndev)`` of this process's
        machines -> ``(ndev, ndev)``: every machine's rows, so that each
        process computes the byte stats from the whole matrices, exactly
        as ``sim`` does (the identity where the stack is whole)."""
        return mats

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` of every process, stacked by process: ``(process_count,
        *x.shape)`` (``x[None]`` where one process holds the stack)."""
        return x[None]

    def broadcast_object(self, obj):
        """Process 0's ``obj`` on every process (host decisions that must
        agree, such as the priors a run starts from)."""
        return obj

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
        """Per-machine off-device sent bytes: row sums with the free
        diagonal masked, f32."""
        return _off_diagonal(byte_matrix).sum(dim=1).to(torch.float32)

    def process_topology(self) -> tuple[int, int]:
        """``(process_index, process_count)``."""
        return 0, 1

    def register_metrics(self, reg, comm_pipeline: bool | None = None
                         ) -> None:
        """Set the exchange-owned instruments on a stats registry."""
        reg["process_index"], reg["process_count"] = self.process_topology()
        reg["comm_pipeline"] = (self.comm_chunks > 1 if comm_pipeline is None
                                else bool(comm_pipeline))
        reg["comm_chunks"] = self.comm_chunks


_BACKENDS: dict[str, type[ExchangeBackend]] = {}


def register_exchange_backend(name: str):
    """Class decorator: make ``Exchange(name)`` resolve to this backend."""
    def deco(cls: type[ExchangeBackend]) -> type[ExchangeBackend]:
        cls.mode = name
        _BACKENDS[name] = cls
        return cls
    return deco


def exchange_backends() -> tuple[str, ...]:
    """Registered backend names (sorted)."""
    return tuple(sorted(_BACKENDS))


def Exchange(mode: str = "sim", wire_format: str = "raw",
             comm_chunks: int = 1) -> ExchangeBackend:
    """The registered backend ``mode`` with the wire format and the
    pipelined sub-exchange count (both transport-independent)."""
    try:
        cls = _BACKENDS[mode]
    except KeyError:
        raise ValueError(
            f"unknown exchange mode {mode!r}; registered backends: "
            f"{list(exchange_backends())}") from None
    if wire_format not in ("raw", "varint"):
        raise ValueError(
            f"unknown wire format {wire_format!r}; expected 'raw' or "
            f"'varint'")
    if not isinstance(comm_chunks, int) or comm_chunks < 1:
        raise ValueError(
            f"comm_chunks must be an int >= 1, got {comm_chunks!r}")
    return cls(wire_format=wire_format, comm_chunks=comm_chunks)


# --------------------------------------------------------------------------- #
# Built-in backends
# --------------------------------------------------------------------------- #
@register_exchange_backend("sim")
@dataclass(frozen=True)
class SimExchange(ExchangeBackend):
    """Single-process reference: the all-to-all is an axis swap."""

    def _a2a(self, x: torch.Tensor) -> torch.Tensor:
        return x.transpose(0, 1)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=0, keepdim=True).expand(x.shape)


@register_exchange_backend("gather")
@dataclass(frozen=True)
class GatherExchange(ExchangeBackend):
    """Per-destination gathers, no collectives: destination ``t`` gathers
    its column from every source.  The same transpose protocol as
    ``sim``, so the results are bit-identical."""

    def _a2a(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack([x.select(1, t) for t in range(x.shape[1])])

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        total = x.sum(dim=0)
        return torch.stack([total] * x.shape[0])


@register_exchange_backend("spmd")
@dataclass(frozen=True)
class SpmdExchange(ExchangeBackend):
    """One process per machine: the rank's block of the stack and real
    ``torch.distributed`` collectives (module docstring)."""

    whole_stack: ClassVar[bool] = False

    def __post_init__(self):
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(
                f"{self.mode} exchange needs an initialized torch.distributed "
                f"process group, one rank per partition (see "
                f"repro_torch.launch.dist_worker)")

    def process_topology(self) -> tuple[int, int]:
        return dist.get_rank(), dist.get_world_size()

    def block(self, ndev: int) -> tuple[int, int]:
        rank, world = self.process_topology()
        if world != ndev:
            raise ValueError(
                f"{self.mode} exchange runs one rank per partition: the "
                f"process group has {world} ranks for {ndev} partitions")
        return rank, 1

    def _a2a(self, x: torch.Tensor) -> torch.Tensor:
        """x: the local ``(1, ndev_dst, ...)`` buffer -> ``(1, ndev_src,
        ...)``."""
        if x.shape[0] != 1:
            raise ValueError(f"{self.mode} a2a takes one machine's buffer, "
                             f"got a leading axis of {x.shape[0]}")
        send = x[0].contiguous()
        wire = send.view(torch.uint8) if send.dtype == torch.bool else send
        out = torch.empty(wire.shape, dtype=wire.dtype, device=wire.device)
        dist.all_to_all_single(out, wire)
        return (out.view(torch.bool) if send.dtype == torch.bool
                else out)[None]

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        y = x.sum(dim=0, keepdim=True)
        dist.all_reduce(y)
        return y.expand(x.shape)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.empty((dist.get_world_size() * x.shape[0],)
                          + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous())
        return out.view((dist.get_world_size(),) + tuple(x.shape))

    def gather_rows(self, *mats: torch.Tensor) -> tuple:
        """One all-gather of every matrix, exact in int64."""
        packed = torch.stack([m.to(torch.int64) for m in mats])
        full = self.all_gather(packed)            # (world, k, nloc, ndev)
        full = full.transpose(0, 1).reshape(len(mats), -1, packed.shape[-1])
        return tuple(f.to(m.dtype) for f, m in zip(full, mats))

    def broadcast_object(self, obj):
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


@register_exchange_backend("dist")
@dataclass(frozen=True)
class DistExchange(SpmdExchange):
    """``spmd`` under the reference's name for its multi-process path;
    everything is inherited."""


# --------------------------------------------------------------------------- #
# Static-shape primitives (leading batch dims allowed; no host syncs)
# --------------------------------------------------------------------------- #
def row_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 running count (or sum, for an integer ``mask``)
    along the last axis; a row's sum wraps mod 2^32 as an int32 scan does.

    Computed as one flat scan minus each row's starting offset: on the
    card, PyTorch scans the last axis of a few long rows with one thread
    block per row, while a 1-D scan uses the whole device.  The flat scan
    may wrap too; the difference is still exact mod 2^32."""
    if mask.numel() >= 1 << 31:
        raise ValueError("row_cumsum scans in int32: too many elements")
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
