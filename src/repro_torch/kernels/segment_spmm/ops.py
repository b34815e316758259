"""segment_spmm entry points: the CUDA kernel on the card, the plain
PyTorch version on the CPU.

``segment_spmm(msgs, dst, n)`` sums edge messages by destination node,
in float32 (the "sum" variant).  ``gat_aggregate(hw, s_src, s_dst, plan,
edge_mask, acc_dtype)`` is one GAT layer's edge softmax and weighted sum
by destination, fused (the "gat" variant): the kernel reads node rows
through the plan and writes no edge-sized tensor.  On the card both work
from a :class:`SegmentPlan`, the destination-sorted CSR of the edge
list, which :func:`segment_plan` builds once per graph: a forward passes
the same plan to every call it makes (``GraphBatch.plan``).  The plan
also orders the rows by in-degree, largest first, and counts the hub
rows, whose in-degree is above ``HUB_DEGREE``: the kernel gives each hub
row a block of its own, and the other rows to lane groups in that
order.

The tensor's device decides the path.  A CUDA tensor launches the
kernel or raises — there is no fallback — and each launch adds one to
:data:`launches` and to its variant's count in
:data:`launches_by_variant`, so a run can show that its main path went
through the kernel.  A CPU tensor runs the plain version
(:func:`segment_spmm_plain`, :func:`gat_aggregate_plain`), and
:func:`segment_spmm` runs it on a ``meta`` tensor too (a shape check, no
data), which launches nothing.

Training differentiates both through :func:`segment_spmm_ad` and
:func:`gat_aggregate_ad`.  On the card they go through the
``torch.autograd.Function`` classes :class:`SegmentSpmm` and
:class:`GatAggregate`, whose backwards launch the kernels "sum_bwd"
(:func:`segment_spmm_bwd`: a gather of the output gradient by
destination) and "gat_bwd" (:func:`gat_aggregate_bwd`:
the edge softmax's gradient from the forward's saved row max and
denominator (:func:`gat_aggregate_with_stats`) and its output, one walk
of the edges by source over :func:`source_plan`), counted in
:data:`bwd_launches_by_variant`.  On the CPU autograd differentiates the
plain versions; :func:`segment_spmm_bwd_plain` and
:func:`gat_aggregate_bwd_plain` are the kernels' plain versions, which
the card's checks hold them against.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.device import PLAIN_DEVICES
from repro_torch.kernels.segment_spmm import kernel
from repro_torch.kernels.segment_spmm.ref import segment_max, segment_sum_dense

launches = 0    # kernel launches since the count was last set to 0
VARIANTS = ("sum", "gat")
launches_by_variant = dict.fromkeys(VARIANTS, 0)   # the same, by variant
BWD_VARIANTS = ("sum_bwd", "gat_bwd")
# backward calls that launched their kernels ("gat_bwd": all three)
bwd_launches_by_variant = dict.fromkeys(BWD_VARIANTS, 0)
DTYPES = (torch.float32, torch.bfloat16)
INDEX_DTYPES = (torch.int32, torch.int64)
MAX_INDEX = 2 ** 31 - 1     # the kernel's edge and node ids are int32
# rows with more in-edges than this get a block of the kernel each (on the
# products-sized graph 16,885 rows, the largest of 16,961 edges; chip_smoke
# phase 9's hub_sweep times other thresholds and none, by setting a plan's
# n_heavy)
HUB_DEGREE = 128
# the "gat" kernel's limits: a lane owns one vector of a row (16 bytes, or
# one value when the row is not a multiple of 16 bytes), so a row has at
# most 32 vectors, and a vector touches at most 2 heads
GAT_MAX_VECTORS = 32
GAT_MAX_HEADS_PER_VECTOR = 2


@dataclass(frozen=True)
class SegmentPlan:
    """The destination-sorted CSR of one edge list: destination ``v``
    owns the edges ``perm[rowptr[v]:rowptr[v + 1]]``, in edge order.
    ``spans`` lists the rows by in-degree, largest first (ties by id),
    each as ``(row, rowptr[row], rowptr[row + 1], 0)``, the kernel's view
    of the CSR (``order`` is its first column); the first ``n_heavy`` are
    the hub rows, with more than :data:`HUB_DEGREE` edges.  Built from the
    sources and the mask too, it holds them in the edges' sorted order
    (``src_sorted``, ``live_sorted``) and keeps the edge list it was
    built from (``src``, ``dst``, ``mask``, not copied)."""

    perm: torch.Tensor      # (E,) int32: edge ids sorted stably by dst
    rowptr: torch.Tensor    # (n + 1,) int32
    spans: torch.Tensor     # (n, 4) int32: rows by in-degree, descending
    n_heavy: int
    dst: torch.Tensor                       # (E,) as given
    src: torch.Tensor | None = None         # (E,) as given
    mask: torch.Tensor | None = None        # (E,) bool as given
    src_sorted: torch.Tensor | None = None  # (E,) int32: src[perm]
    live_sorted: torch.Tensor | None = None  # (E,) bool: mask[perm]

    @property
    def n(self) -> int:
        return self.rowptr.numel() - 1

    @property
    def n_edges(self) -> int:
        return self.perm.numel()

    @property
    def order(self) -> torch.Tensor:
        """The rows by in-degree, largest first."""
        return self.spans[:, 0]

    @property
    def heavy(self) -> torch.Tensor:
        """The hub rows, largest first."""
        return self.order[:self.n_heavy]


def segment_plan(dst: torch.Tensor, n: int, src: torch.Tensor | None = None,
                 mask: torch.Tensor | None = None) -> SegmentPlan:
    """The :class:`SegmentPlan` of ``dst`` (E,) int32/int64 ids in
    ``[0, n)``: a stable sort of the edges by destination, the row
    pointers from a ``bincount`` and a ``cumsum``, the rows by in-degree
    and the count of those above :data:`HUB_DEGREE`; with ``src`` (E,)
    ids and ``mask`` (E,) bool, also both in the sorted order (GAT's
    kernel needs both).
    Preprocessing, run once per graph; it reads the counts' length, so
    it waits for the device."""
    if dst.dim() != 1 or dst.dtype not in INDEX_DTYPES:
        raise ValueError(f"segment_plan wants dst (E,) int32 or int64, got "
                         f"{tuple(dst.shape)} {dst.dtype}")
    if dst.numel() > MAX_INDEX or not 0 <= n <= MAX_INDEX:
        raise ValueError(f"segment_plan takes E and n below 2**31, got "
                         f"E={dst.numel()}, n={n}")
    for name, t, dtypes in (("src", src, INDEX_DTYPES),
                            ("mask", mask, (torch.bool,))):
        if t is not None and (t.shape != dst.shape or t.dtype not in dtypes
                              or t.device != dst.device):
            raise ValueError(f"segment_plan wants {name} like dst "
                             f"{tuple(dst.shape)} on {dst.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    counts = torch.bincount(dst, minlength=n)     # raises on ids < 0
    if counts.numel() != n:
        raise ValueError(f"segment_plan: dst holds ids >= n = {n}")
    perm = torch.sort(dst, stable=True).indices.to(torch.int32)
    rowptr = torch.zeros(n + 1, dtype=torch.int32, device=dst.device)
    rowptr[1:] = counts.cumsum(0)
    order = torch.sort(counts, descending=True, stable=True).indices
    spans = torch.stack([order.to(torch.int32), rowptr[order],
                         rowptr[order + 1], torch.zeros_like(rowptr[1:])], 1)
    n_heavy = int((counts > HUB_DEGREE).sum())
    return SegmentPlan(
        perm, rowptr, spans, n_heavy, dst, src, mask,
        None if src is None else src.index_select(0, perm).to(torch.int32),
        None if mask is None else mask.index_select(0, perm))


@functools.lru_cache(maxsize=32)
def bag_plan(n_bags: int, bag_size: int, device) -> SegmentPlan:
    """The plan of ``n_bags`` regular bags of ``bag_size`` consecutive
    messages each, ``dst = repeat(arange(n_bags), bag_size)`` (int64):
    field for field what ``segment_plan(dst, n_bags)`` builds, in closed
    form, so that no call waits for the device (``segment_plan`` reads
    its counts back).  Cached per ``(n_bags, bag_size, device)``: a
    serving call with a batch size seen before builds nothing."""
    E = n_bags * bag_size
    if E > MAX_INDEX or not 0 <= n_bags <= MAX_INDEX or bag_size < 0:
        raise ValueError(f"bag_plan takes E and n below 2**31, got "
                         f"{n_bags} bags of {bag_size}")
    rows = torch.arange(n_bags, dtype=torch.int32, device=device)
    rowptr = torch.arange(n_bags + 1, dtype=torch.int32,
                          device=device) * bag_size
    spans = torch.stack([rows, rowptr[:-1], rowptr[1:],
                         torch.zeros_like(rows)], 1)
    dst = rows.long()[:, None].expand(n_bags, bag_size).reshape(E)
    return SegmentPlan(torch.arange(E, dtype=torch.int32, device=device),
                       rowptr, spans, n_bags if bag_size > HUB_DEGREE else 0,
                       dst)


def source_plan(plan: SegmentPlan) -> SegmentPlan:
    """The plan of ``plan``'s edges by source, over ``plan``'s edge
    positions: source ``u`` owns the positions ``perm[rowptr[u]:rowptr[u
    + 1]]`` of ``plan``'s sorted order (ascending), ``src_sorted`` holds
    each one's destination and ``live_sorted`` its mask.  "gat_bwd"
    walks it to sum the gradients of hw and s_src by source, writing
    each edge's score gradient at its position in ``plan``'s order.
    ``plan`` must carry the sources and the mask (``GraphBatch.gat_plan``);
    built once per graph (``GraphBatch.gat_source_plan``)."""
    if plan.src_sorted is None or plan.live_sorted is None:
        raise ValueError("source_plan wants a plan built with src and mask")
    dst_sorted = plan.dst.index_select(0, plan.perm).to(torch.int32)
    return segment_plan(plan.src_sorted, plan.n, src=dst_sorted,
                        mask=plan.live_sorted)


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


def _count(variant: str) -> None:
    global launches
    launches += 1
    launches_by_variant[variant] += 1


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
    if msgs.device.type in PLAIN_DEVICES:
        return segment_spmm_plain(msgs, dst, n, plan, out_dtype)
    _check(msgs, dst, n, plan, out_dtype)
    if msgs.device.type != "cuda":
        raise ValueError(f"segment_spmm runs on cuda or cpu, not "
                         f"{msgs.device}")
    if plan is None:
        plan = segment_plan(dst, n)
    E, tail = msgs.shape[0], msgs.shape[1:]
    flat = msgs.reshape(E, math.prod(tail)).contiguous()
    out = torch.empty((n, flat.shape[1]), dtype=out_dtype,
                      device=msgs.device)
    if out.numel():
        kernel.segment_spmm_cuda(flat, plan, out)
        _count("sum")
    return out.reshape(n, *tail)


def _check_gat(hw, s_src, s_dst, plan: SegmentPlan, edge_mask,
               acc_dtype) -> None:
    if hw.dim() != 3 or s_src.shape != hw.shape[:2] \
            or s_dst.shape != hw.shape[:2]:
        raise ValueError(f"gat_aggregate wants hw (N, H, dout) and s_src, "
                         f"s_dst (N, H), got {tuple(hw.shape)}, "
                         f"{tuple(s_src.shape)}, {tuple(s_dst.shape)}")
    if hw.dtype not in DTYPES or s_src.dtype != hw.dtype \
            or s_dst.dtype != hw.dtype or acc_dtype not in DTYPES:
        raise TypeError(f"gat_aggregate wants hw, s_src, s_dst of one dtype "
                        f"and acc_dtype, each float32 or bfloat16, got "
                        f"{hw.dtype}, {s_src.dtype}, {s_dst.dtype}, "
                        f"{acc_dtype}")
    if plan.src is None or plan.n != hw.shape[0] \
            or edge_mask.shape != (plan.n_edges,) \
            or edge_mask.dtype != torch.bool:
        raise ValueError(f"gat_aggregate wants the plan of the graph's "
                         f"edges (built with src) over N = {hw.shape[0]} "
                         f"nodes and edge_mask ({plan.n_edges},) bool, got "
                         f"a plan over {plan.n} nodes and a mask "
                         f"{tuple(edge_mask.shape)} {edge_mask.dtype}")
    if not (hw.device == s_src.device == s_dst.device == edge_mask.device
            == plan.perm.device):
        raise ValueError("gat_aggregate wants every tensor on one device")


def gat_shape_fits(heads: int, dout: int, dtype: torch.dtype) -> bool:
    """Whether the "gat" kernel takes rows of ``heads * dout`` values of
    ``dtype`` (contiguous, 16-byte aligned): at most
    :data:`GAT_MAX_VECTORS` vectors a row, each touching at most
    :data:`GAT_MAX_HEADS_PER_VECTOR` heads."""
    d = heads * dout
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    if d % vec:
        return d <= GAT_MAX_VECTORS          # one value a vector
    return d // vec <= GAT_MAX_VECTORS and all(
        (c + vec - 1) // dout - c // dout < GAT_MAX_HEADS_PER_VECTOR
        for c in range(0, d, vec))


def _gat_scores(s_src: torch.Tensor, s_dst: torch.Tensor,
                src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``leaky_relu(s_src[src] + s_dst[dst], 0.2)`` as float32, computed
    as the reference's ``jax.nn.leaky_relu`` is, ``where(x >= 0, x,
    0.2 * x)``: the values of ``torch.nn.functional.leaky_relu``, but
    autograd's slope at ``x == 0`` is 1, as JAX's is."""
    x = s_src.index_select(0, src) + s_dst.index_select(0, dst)
    return torch.where(x >= 0, x, x * 0.2).float()


def _gat_softmax_plain(s_src, s_dst, plan: SegmentPlan, edge_mask,
                       acc_dtype):
    """The segment softmax's parts in the reference's order of
    operations: each row's and head's max score ``m`` (N, H) float32
    (``-inf`` for a row without a live edge), the edges' ``acc_dtype``
    exponentials ``ex`` (E, H) (0 on masked slots), and the rows'
    clamped denominators ``den`` (N, H) float32."""
    N, dst = s_src.shape[0], plan.dst
    dropped = ~edge_mask[:, None]
    score = _gat_scores(s_src, s_dst, plan.src, dst)
    score = score.masked_fill(dropped, -math.inf)
    m = segment_max(score, dst.long(), N)           # (N, H) f32
    ex = torch.exp(score - m.index_select(0, dst)).to(acc_dtype)
    del score
    ex = ex.masked_fill(dropped, 0)
    den = segment_spmm_plain(ex, dst, N, plan, out_dtype=ex.dtype)
    return m, ex, torch.clamp_min(den.float(), 1e-9)


def gat_row_stats_plain(s_src: torch.Tensor, s_dst: torch.Tensor,
                        plan: SegmentPlan, edge_mask: torch.Tensor,
                        acc_dtype: torch.dtype):
    """The plain version of the row statistics that "gat" saves for its
    backward (:func:`gat_aggregate_with_stats`): ``(m, den)``, each (N,
    H) float32, every row's and head's max score (``-inf`` without a
    live edge) and its denominator ``max(acc(sum of acc(exp(score -
    m))), 1e-9)``."""
    m, _, den = _gat_softmax_plain(s_src, s_dst, plan, edge_mask,
                                   acc_dtype)
    return m, den


def gat_messages_plain(hw: torch.Tensor, s_src: torch.Tensor,
                       s_dst: torch.Tensor, plan: SegmentPlan,
                       edge_mask: torch.Tensor,
                       acc_dtype: torch.dtype) -> torch.Tensor:
    """The (E, H, dout) ``acc_dtype`` messages that
    :func:`gat_aggregate_plain` sums by destination: SDDMM edge scores
    and the segment softmax as edge-sized tensors, in the reference's
    order of operations, each dropped as soon as that order allows (at
    ogbn-products' size the messages are 7.9 GB in bf16 and 15.8 GB in
    f32).  Every op is out of place, so autograd differentiates it: the
    plain backward on the CPU."""
    _check_gat(hw, s_src, s_dst, plan, edge_mask, acc_dtype)
    _, ex, den = _gat_softmax_plain(s_src, s_dst, plan, edge_mask,
                                    acc_dtype)
    alpha = (ex.float() / den.index_select(0, plan.dst)).to(hw.dtype)
    del ex, den
    return (alpha[..., None] * hw.index_select(0, plan.src)).to(acc_dtype)


def gat_aggregate_plain(hw: torch.Tensor, s_src: torch.Tensor,
                        s_dst: torch.Tensor, plan: SegmentPlan,
                        edge_mask: torch.Tensor,
                        acc_dtype: torch.dtype) -> torch.Tensor:
    """The plain version of :func:`gat_aggregate`, on any device: the
    messages of :func:`gat_messages_plain` summed by
    :func:`segment_spmm_plain`."""
    msg = gat_messages_plain(hw, s_src, s_dst, plan, edge_mask, acc_dtype)
    return segment_spmm_plain(msg, plan.dst, hw.shape[0], plan,
                              out_dtype=acc_dtype)


def gat_aggregate(hw: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor,
                  plan: SegmentPlan, edge_mask: torch.Tensor,
                  acc_dtype: torch.dtype) -> torch.Tensor:
    """One GAT layer's aggregation: hw (N, H, dout), s_src and s_dst (N,
    H) float32 or bfloat16 (the model dtype ``dt``), ``plan`` the
    :func:`segment_plan` of the edges built with their sources and
    ``edge_mask``, which marks the live edge slots -> (N, H, dout)
    ``acc_dtype``.  For destination v and its live edges e, per head:
    ``score_e = leaky_relu(s_src[src_e] + s_dst[v], 0.2)`` in ``dt``,
    ``alpha_e = dt(acc(exp(score_e - max)) / max(acc(sum), 1e-9))`` and
    ``out_v = acc(sum of acc(dt(alpha_e * hw[src_e])))``, every sum in
    float32; a row without a live edge gets 0.  On the card the kernel
    computes it in three passes over the row's edges and raises for rows
    it does not take (:func:`gat_shape_fits`)."""
    if hw.device.type == "cpu":
        return gat_aggregate_plain(hw, s_src, s_dst, plan, edge_mask,
                                   acc_dtype)
    return _gat_aggregate_cuda(hw, s_src, s_dst, plan, edge_mask,
                               acc_dtype, stats=False)[0]


def _gat_aggregate_cuda(hw, s_src, s_dst, plan, edge_mask, acc_dtype,
                        stats: bool):
    """"gat" on the card: ``(out, m, den)``, the row statistics (N, H)
    float32 written by the kernel when ``stats``, else None."""
    _check_gat(hw, s_src, s_dst, plan, edge_mask, acc_dtype)
    if hw.device.type != "cuda":
        raise ValueError(f"gat_aggregate runs on cuda or cpu, not "
                         f"{hw.device}")
    if plan.mask is not edge_mask:
        raise ValueError("gat_aggregate: the plan was built from another "
                         "edge_mask")
    N, H, dout = hw.shape
    if not gat_shape_fits(H, dout, hw.dtype):
        raise ValueError(f"gat_aggregate's kernel takes rows of at most "
                         f"{GAT_MAX_VECTORS} vectors of 16 bytes, each over "
                         f"at most {GAT_MAX_HEADS_PER_VECTOR} heads; H={H}, "
                         f"dout={dout} in {hw.dtype} does not fit")
    out = torch.empty((N, H, dout), dtype=acc_dtype, device=hw.device)
    m = den = None
    if stats:
        m = torch.empty((N, H), dtype=torch.float32, device=hw.device)
        den = torch.empty_like(m)
    if out.numel():
        kernel.gat_aggregate_cuda(hw.contiguous(), s_src.contiguous(),
                                  s_dst.contiguous(), plan, out, m, den)
        _count("gat")
    return out, m, den


def gat_aggregate_with_stats(hw: torch.Tensor, s_src: torch.Tensor,
                             s_dst: torch.Tensor, plan: SegmentPlan,
                             edge_mask: torch.Tensor,
                             acc_dtype: torch.dtype):
    """:func:`gat_aggregate` that also returns the row statistics its
    backward starts from: ``(out, m, den)``, ``m`` and ``den`` (N, H)
    float32 as :func:`gat_row_stats_plain` defines them.  On the card
    the one "gat" launch writes them (``out`` has the same bits as
    without them); on the CPU the plain versions compute them."""
    if hw.device.type == "cpu":
        return (gat_aggregate_plain(hw, s_src, s_dst, plan, edge_mask,
                                    acc_dtype),
                *gat_row_stats_plain(s_src, s_dst, plan, edge_mask,
                                     acc_dtype))
    return _gat_aggregate_cuda(hw, s_src, s_dst, plan, edge_mask, acc_dtype,
                               stats=True)


# --------------------------------------------------------------------------- #
# backward
# --------------------------------------------------------------------------- #
# edges a step of the plain GAT backward's (E, H, dout) terms: 0.5 GB of
# f32 at GAT's widths, where the whole products-sized graph takes 16 GB
BWD_PLAIN_CHUNK = 1 << 21
def segment_spmm_bwd_plain(dout: torch.Tensor, dst: torch.Tensor,
                           msgs_dtype: torch.dtype) -> torch.Tensor:
    """The plain version of :func:`segment_spmm_bwd`, on any device:
    ``dout.index_select(0, dst)`` in the messages' dtype."""
    return dout.index_select(0, dst).to(msgs_dtype)


def segment_spmm_bwd(dout: torch.Tensor, dst: torch.Tensor, n: int,
                     plan: SegmentPlan | None,
                     msgs_dtype: torch.dtype) -> torch.Tensor:
    """The gradient of :func:`segment_spmm` with respect to its messages:
    dout (n, ...) in the forward's ``out_dtype`` -> (E, ...)
    ``msgs_dtype``, ``dmsgs[e] = dout[dst[e]]`` (the "sum_bwd" kernel on
    a CUDA tensor, walking the forward's ``plan``, else the plain
    version).  At GraphCast's Cora-sized shapes the call's host time is
    most of its cost, so the path reads no ``device`` object and does
    not reshape a 2-D ``dout``."""
    if dout.is_cpu:
        return segment_spmm_bwd_plain(dout, dst, msgs_dtype)
    if not dout.is_cuda:
        raise ValueError(f"segment_spmm_bwd runs on cuda or cpu, not "
                         f"{dout.device}")
    if dout.shape[0] != n or msgs_dtype not in DTYPES \
            or dout.dtype not in (torch.float32, msgs_dtype):
        raise ValueError(f"segment_spmm_bwd wants dout (n={n}, ...) in "
                         f"float32 or {msgs_dtype}, got "
                         f"{tuple(dout.shape)} {dout.dtype}")
    if plan is None:
        plan = segment_plan(dst, n)
    flat = (dout if dout.dim() == 2
            else dout.reshape(n, math.prod(dout.shape[1:]))).contiguous()
    dmsgs = flat.new_empty((plan.n_edges, flat.shape[1]), dtype=msgs_dtype)
    if dmsgs.numel():
        kernel.segment_spmm_bwd_cuda(flat, plan, dmsgs)
        bwd_launches_by_variant["sum_bwd"] += 1
    return (dmsgs if dout.dim() == 2
            else dmsgs.reshape(plan.n_edges, *dout.shape[1:]))


class SegmentSpmm(torch.autograd.Function):
    """Differentiable :func:`segment_spmm` with respect to its messages:
    the backward is :func:`segment_spmm_bwd` over the forward's plan."""

    @staticmethod
    def forward(ctx, msgs, dst, n: int, plan, out_dtype):
        if plan is None:
            plan = segment_plan(dst, n)
        ctx.dst, ctx.n, ctx.plan, ctx.msgs_dtype = dst, n, plan, msgs.dtype
        return segment_spmm(msgs, dst, n, plan, out_dtype)

    @staticmethod
    def backward(ctx, dout):
        return (segment_spmm_bwd(dout, ctx.dst, ctx.n, ctx.plan,
                                 ctx.msgs_dtype), None, None, None, None)


def segment_spmm_ad(msgs: torch.Tensor, dst: torch.Tensor, n: int,
                    plan: SegmentPlan | None = None,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`segment_spmm`, differentiable: on the card through
    :class:`SegmentSpmm` when gradients are on and ``msgs`` requires one,
    else the plain call (on the CPU autograd differentiates the plain
    version)."""
    if (msgs.device.type not in PLAIN_DEVICES and torch.is_grad_enabled()
            and msgs.requires_grad):
        return SegmentSpmm.apply(msgs, dst, n, plan, out_dtype)
    return segment_spmm(msgs, dst, n, plan, out_dtype)


def gat_aggregate_bwd_plain(hw: torch.Tensor, s_src: torch.Tensor,
                            s_dst: torch.Tensor, plan: SegmentPlan,
                            edge_mask: torch.Tensor, acc_dtype: torch.dtype,
                            dout: torch.Tensor, m: torch.Tensor,
                            den: torch.Tensor, out: torch.Tensor):
    """The plain version of :func:`gat_aggregate_bwd`, on any device,
    with the kernel's arithmetic: from the forward's row statistics ``m``
    and ``den`` (:func:`gat_row_stats_plain`) and its output ``out``,
    the forward's values recomputed with its roundings, then, per head
    and edge e (destination v, source u), ``dalpha_e = <dt(dout[v]),
    hw[u]>``, ``delta_v = <dt(dout[v]), out[v]>``, ``da_e = p_e *
    (dalpha_e - delta_v) / den_v``, times 0.2 where the score is negative
    (slope 1 at 0, as the reference's), and the sums ``ds_dst[v]``,
    ``ds_src[u]`` of ``da_e`` and ``dhw[u]`` of ``dt(dout[v]) *
    alpha_e``, every sum in float32, rounded to ``hw``'s dtype once.
    The (E, H, dout) terms are taken :data:`BWD_PLAIN_CHUNK` edges at a
    time."""
    _check_gat(hw, s_src, s_dst, plan, edge_mask, acc_dtype)
    N, H, dd = hw.shape
    dt, E = hw.dtype, plan.n_edges
    src, dst = plan.src.long(), plan.dst.long()
    dropped = ~edge_mask[:, None]
    sc = _gat_scores(s_src, s_dst, src, dst)
    sc = sc.masked_fill(dropped, -math.inf)
    p = torch.exp(sc - m.index_select(0, dst)).masked_fill(dropped, 0)
    den_e = den.index_select(0, dst)
    alpha = (p.to(acc_dtype).float() / den_e).to(dt).float()
    dv = dout.to(dt).float()                       # (N, H, dd)
    delta = (dv * out.float()).sum(-1)             # (N, H)
    hw32 = hw.float()
    dalpha = torch.empty_like(p)
    dhw = torch.zeros((N, H * dd), dtype=torch.float32, device=hw.device)
    for i in range(0, E, BWD_PLAIN_CHUNK):
        j = min(i + BWD_PLAIN_CHUNK, E)
        dprod = dv.index_select(0, dst[i:j])
        dalpha[i:j] = (dprod * hw32.index_select(0, src[i:j])).sum(-1)
        term = (dprod * alpha[i:j, :, None]).masked_fill(
            dropped[i:j, :, None], 0)
        dhw.index_add_(0, src[i:j], term.reshape(j - i, H * dd))
        del dprod, term
    ds = p * (dalpha - delta.index_select(0, dst)) / den_e
    da = torch.where(sc >= 0, ds, 0.2 * ds).masked_fill(dropped, 0)
    return (dhw.to(dt).reshape(N, H, dd),
            segment_sum_dense(da, src, N).to(dt),
            segment_sum_dense(da, dst, N).to(dt))


def gat_aggregate_bwd(hw: torch.Tensor, s_src: torch.Tensor,
                      s_dst: torch.Tensor, plan: SegmentPlan,
                      edge_mask: torch.Tensor, acc_dtype: torch.dtype,
                      dout: torch.Tensor, m: torch.Tensor, den: torch.Tensor,
                      out: torch.Tensor, plan_by_src: SegmentPlan):
    """The gradient of :func:`gat_aggregate`: ``(dhw, ds_src, ds_dst)``
    in hw's dtype, from ``dout`` (N, H, dout) ``acc_dtype``, the
    gradient of its output, and what :func:`gat_aggregate_with_stats`
    gave: the row statistics ``m`` and ``den`` (N, H) float32 and the
    output ``out``.  A CUDA tensor launches "gat_bwd" (its three kernels;
    ``plan_by_src`` is :func:`source_plan` of ``plan``) or raises for
    shapes the forward kernel does not take; a CPU tensor runs
    :func:`gat_aggregate_bwd_plain`."""
    if hw.device.type == "cpu":
        return gat_aggregate_bwd_plain(hw, s_src, s_dst, plan, edge_mask,
                                       acc_dtype, dout, m, den, out)
    _check_gat(hw, s_src, s_dst, plan, edge_mask, acc_dtype)
    if hw.device.type != "cuda":
        raise ValueError(f"gat_aggregate_bwd runs on cuda or cpu, not "
                         f"{hw.device}")
    if plan.mask is not edge_mask:
        raise ValueError("gat_aggregate_bwd: the plan was built from "
                         "another edge_mask")
    N, H, dd = hw.shape
    for name, t, dtype, shape in (("dout", dout, acc_dtype, hw.shape),
                                  ("out", out, acc_dtype, hw.shape),
                                  ("m", m, torch.float32, (N, H)),
                                  ("den", den, torch.float32, (N, H))):
        if t.shape != shape or t.dtype != dtype or t.device != hw.device:
            raise ValueError(f"gat_aggregate_bwd wants {name} "
                             f"{tuple(shape)} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not gat_shape_fits(H, dd, hw.dtype):
        raise ValueError(f"gat_aggregate_bwd's kernel takes the forward's "
                         f"rows; H={H}, dout={dd} in {hw.dtype} does not "
                         f"fit")
    dhw = torch.empty_like(hw)
    ds_src, ds_dst = torch.empty_like(s_src), torch.empty_like(s_dst)
    if hw.numel():
        dev = hw.device
        rec = torch.empty((N, H, 4), dtype=torch.float32, device=dev)
        # the messages' gradient is dout rounded to hw's dtype: a bf16
        # copy where dout is f32 and hw bf16, else dout itself
        dout_td = (torch.empty_like(hw) if hw.dtype == torch.bfloat16
                   and acc_dtype == torch.float32 else None)
        da = torch.empty((plan.n_edges, H), dtype=torch.float32, device=dev)
        kernel.gat_bwd_cuda(hw.contiguous(), s_src.contiguous(),
                            s_dst.contiguous(), m.contiguous(),
                            den.contiguous(), out.contiguous(),
                            dout.contiguous(), plan, plan_by_src, rec,
                            dout_td, da, dhw, ds_src, ds_dst)
        bwd_launches_by_variant["gat_bwd"] += 1
    return dhw, ds_src, ds_dst


class GatAggregate(torch.autograd.Function):
    """Differentiable :func:`gat_aggregate`: the forward
    (:func:`gat_aggregate_with_stats`) saves its inputs, its output and
    each row's max and denominator; the backward is
    :func:`gat_aggregate_bwd`, which starts from them."""

    @staticmethod
    def forward(ctx, hw, s_src, s_dst, plan, edge_mask, acc_dtype,
                plan_by_src):
        out, m, den = gat_aggregate_with_stats(hw, s_src, s_dst, plan,
                                               edge_mask, acc_dtype)
        ctx.save_for_backward(hw, s_src, s_dst, m, den, out)
        ctx.plan, ctx.edge_mask, ctx.acc_dtype = plan, edge_mask, acc_dtype
        ctx.plan_by_src = plan_by_src
        return out

    @staticmethod
    def backward(ctx, dout):
        hw, s_src, s_dst, m, den, out = ctx.saved_tensors
        grads = gat_aggregate_bwd(hw, s_src, s_dst, ctx.plan, ctx.edge_mask,
                                  ctx.acc_dtype, dout.contiguous(), m, den,
                                  out, ctx.plan_by_src())
        return (*grads, None, None, None, None)


def gat_aggregate_ad(hw: torch.Tensor, s_src: torch.Tensor,
                     s_dst: torch.Tensor, plan: SegmentPlan,
                     edge_mask: torch.Tensor, acc_dtype: torch.dtype,
                     plan_by_src) -> torch.Tensor:
    """:func:`gat_aggregate`, differentiable: on the card through
    :class:`GatAggregate` when gradients are on and an input requires
    one, else the plain call (on the CPU autograd differentiates the
    plain version).  ``plan_by_src`` is a function that returns the
    :func:`source_plan` of ``plan`` (``GraphBatch.gat_source_plan``),
    called by the card's backward only."""
    if (hw.device.type != "cpu" and torch.is_grad_enabled()
            and (hw.requires_grad or s_src.requires_grad
                 or s_dst.requires_grad)):
        return GatAggregate.apply(hw, s_src, s_dst, plan, edge_mask,
                                  acc_dtype, plan_by_src)
    return gat_aggregate(hw, s_src, s_dst, plan, edge_mask, acc_dtype)
