"""R-Meef: region-grouped multi-round expand, verify & filter (§3, App. B).

The port of the reference engine (every exchange backend, storage and
wire format).  One vectorized, static-shape engine serves two roles:

* **SM-E** (``local_only=True``): the single-machine pass over seeds whose
  border distance >= span(u_start) (Prop. 1) — no exchanges at all;
* **distributed R-Meef** (``local_only=False``): per unit (= round),
  ``fetchV`` (batched foreign-adjacency fetch with dedup and the adjacency
  cache), per-leaf expansion with local verification, then one batched
  ``verifyE`` exchange over the EVI (deduped undetermined edges; Def. 5).

Every tensor carries a leading axis of the machines this process holds,
the device graph's block ``g.dev0 .. g.dev0 + g.nloc - 1`` of ``g.ndev``:
all of them under ``sim`` and ``gather``, the rank's own under
``spmd``/``dist``, where the two exchanges are real collectives between
processes.  The per-device functions the reference vmaps are written
batched over that axis; machine ids in the data (owners, peers) are
global.  The byte stats are computed from per-peer matrices of every
machine (``exch.gather_rows``), so each rank holds ``sim``'s stats, bit
for bit.  Shapes come from ``EngineConfig``; every
overflow is flagged, and the scheduler reacts by splitting region groups
(§6 memory control).  Nothing here synchronises with the host: stages
only enqueue work, and a wave's results reach the host in one copy when
the scheduler retires it.

The round is split into three stages over a :class:`WaveState` —
:func:`fetch_stage`, :func:`expand_stage`, :func:`verify_stage` — so the
scheduler can keep several waves in flight; :func:`run_rounds` is their
synchronous composition.

The engine reads adjacency only through the
:class:`~repro_torch.graph.storage.DeviceGraph` interface, so ``dense``
and ``bucketed`` storage give byte-identical results.  With the
``varint`` wire both exchanges encode their payloads into ``uint8``
streams (:mod:`repro_torch.core.wire`) and decode them on the receiving
side; ``bytes_wire_*`` count the stream lengths, ``bytes_fetch``/
``bytes_verify`` keep the raw-equivalent accounting.

Kernels (the hand-written CUDA kernel on the card, its plain PyTorch
version on the CPU):

* membership — the dense back-edge filter in ``_leaf_step`` and the
  owner-side ``verifyE`` answer
  (:func:`repro_torch.kernels.membership.ops.membership`);
* intersect — the back-edge filter on the bucketed layout
  (:func:`repro_torch.kernels.intersect.ops.intersect`);
* varint_encode / varint_decode — the varint fetchV codecs: request
  ids out, response rows out, response rows back onto the requesters'
  slots (:mod:`repro_torch.kernels.varint.ops`, through
  :mod:`repro_torch.core.wire`).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.configs.rads import EngineConfig
from repro_torch.core import wire as wire_codec
from repro_torch.core.cache import AdjCache, probe_lines
from repro_torch.core.exchange import (ExchangeBackend, compact_index,
                                       masked, unique_ids, unique_pairs)
from repro_torch.core.plan import Plan
from repro_torch.graph.storage import DeviceGraph
from repro_torch.kernels.intersect.ops import intersect
from repro_torch.kernels.membership.ops import membership


# The stages work on every device at once, but the few tensors of shape
# (devices, rows, max_degree) in a leaf step or a verifyE answer are
# built for at most this many elements at a time: the devices go in
# chunks, so an escalated frontier raises the peak memory by at most this
# much instead of ndev times its per-device size.  At the default caps the
# whole stack is one chunk.  Results do not depend on the chunking.
CHUNK_ELEMS = 1 << 30


def _device_chunks(ndev: int, elems_per_device: int) -> list[tuple[int, int]]:
    step = max(1, CHUNK_ELEMS // max(elems_per_device, 1))
    return [(t0, min(t0 + step, ndev)) for t0 in range(0, ndev, step)]


def _dev_ids(t0: int, t1: int, device, ndim: int) -> torch.Tensor:
    """int32 device ids ``t0..t1-1`` shaped ``(t1 - t0, 1, ...)`` to
    broadcast against a stacked tensor of ``ndim`` dims."""
    return torch.arange(t0, t1, dtype=torch.int32, device=device).view(
        (t1 - t0,) + (1,) * (ndim - 1))


def _backedge_mask(g: DeviceGraph, w_row: torch.Tensor,
                   cand: torch.Tensor) -> torch.Tensor:
    """Candidate-generation back-edge filter: is ``cand[r, j]`` in
    ``w_row[r]``?  Formats with ``intersect_backedge`` (the bucketed
    layout) route the sorted-window intersection ``C(u) ∩ adj(f(u'))``
    through the intersect kernel, the rest through membership.  The two
    differ only where ``cand`` is the sentinel, which the caller has
    already invalidated, so the final masks are identical."""
    if g.intersect_backedge:
        return intersect(cand, w_row, g.n)[0]
    return membership(w_row, cand)


def _to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(x)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


# --------------------------------------------------------------------------- #
# Static plan data
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class StepSpec:
    col: int                      # column this leaf writes (matching order)
    piv_col: int
    unit_idx: int
    leaf: int                     # query vertex id
    leaf_deg: int                 # degree filter
    back_cols: tuple[int, ...]    # earlier cols with an edge to leaf (no pivot)
    sym_lt_cols: tuple[int, ...]  # require rows[:, c] <  cand
    sym_gt_cols: tuple[int, ...]  # require cand < rows[:, c]


@dataclass(frozen=True)
class PlanData:
    order: tuple[int, ...]
    col_of: tuple[int, ...]                  # query vertex -> column
    steps: tuple[StepSpec, ...]
    unit_piv_cols: tuple[int, ...]
    unit_steps: tuple[tuple[int, ...], ...]  # step indices per unit
    start_deg: int
    u_start: int
    span_start: int


def build_plan_data(plan: Plan) -> PlanData:
    p = plan.pattern
    order = plan.matching_order
    if not order:
        raise ValueError("plan must carry a matching order (use best_plan)")
    col_of = [0] * p.n
    for i, u in enumerate(order):
        col_of[u] = i
    cons = p.symmetry_constraints()
    steps: list[StepSpec] = []
    unit_piv_cols: list[int] = []
    unit_steps: list[tuple[int, ...]] = []
    placed = {order[0]}
    for ui, unit in enumerate(plan.units):
        piv_col = col_of[unit.piv]
        unit_piv_cols.append(piv_col)
        sids: list[int] = []
        for lf in sorted(unit.leaves, key=lambda v: col_of[v]):
            back = tuple(col_of[w] for w in p.adj(lf)
                         if w in placed and w != unit.piv)
            lt = tuple(col_of[a] for (a, b) in cons if b == lf and a in placed)
            gt = tuple(col_of[b] for (a, b) in cons if a == lf and b in placed)
            steps.append(StepSpec(col=col_of[lf], piv_col=piv_col,
                                  unit_idx=ui, leaf=lf,
                                  leaf_deg=p.degree(lf), back_cols=back,
                                  sym_lt_cols=lt, sym_gt_cols=gt))
            sids.append(len(steps) - 1)
            placed.add(lf)
        unit_steps.append(tuple(sids))
    return PlanData(order=order, col_of=tuple(col_of), steps=tuple(steps),
                    unit_piv_cols=tuple(unit_piv_cols),
                    unit_steps=tuple(unit_steps),
                    start_deg=p.degree(order[0]), u_start=order[0],
                    span_start=p.span(order[0]))


# --------------------------------------------------------------------------- #
# fetchV / verifyE exchanges
# --------------------------------------------------------------------------- #
def _per_peer_compact(ids, mask, owners, ndev: int, cap_out: int, fill: int,
                      extras: tuple = ()):
    """Split sorted id lists ``(nloc, N)`` into per-peer request buffers
    ``(nloc, ndev, cap_out)``.

    ``extras``: ``(tensor (nloc, N, ...), fill)`` pairs co-compacted with
    ``ids``.  Returns ``(reqs, *extras_compacted, counts (nloc, ndev),
    overflow)``; order within a peer stays sorted."""
    peers = torch.arange(ndev, dtype=owners.dtype, device=ids.device)
    m = mask[:, None, :] & (owners[:, None, :] == peers[None, :, None])
    new_mask, ov, take = compact_index(m, cap_out)      # (nloc, ndev, cap)
    t = torch.arange(ids.shape[0], device=ids.device).view(-1, 1, 1)
    outs = []
    for a, fl in ((ids, fill), *extras):
        outs.append(masked(a[t, take], new_mask, fl))
    return (*outs, m.sum(-1), ov.any())


def _varint_id_bytes(wire: torch.Tensor, n: int) -> torch.Tensor:
    """Modeled delta+varint size of the fetchV id payloads.

    ``wire``: (nloc, peer, fcap) request buffers — ids ascending among the
    valid (< n) entries, sentinel holes allowed.  Each peer stream is
    delta-coded against the previous valid id (the first id absolute) and
    each delta LEB128-sized; returns the per-(src, peer) byte matrix."""
    valid = wire < n
    run = torch.cummax(masked(wire, valid, -1), dim=-1).values
    prev = torch.cat([torch.full_like(run[..., :1], -1), run[..., :-1]],
                     dim=-1)
    delta = torch.where(prev >= 0, wire - prev, wire).clamp(min=0)
    # deltas >= 2^28 would take 5 LEB128 bytes; the modeled format falls
    # back to the raw 4-byte int32 for those
    vlen = (1 + (delta >= 1 << 7).to(torch.int32)
            + (delta >= 1 << 14).to(torch.int32)
            + (delta >= 1 << 21).to(torch.int32))
    return masked(vlen, valid, 0).sum(-1)


def fetch_exchange(g: DeviceGraph, exch: ExchangeBackend, pivots, need,
                   fcap: int, cache: AdjCache | None = None):
    """Batched fetchV (§3.2 Expand): dedup foreign pivot ids, probe the
    adjacency cache, exchange the misses, answer with local adjacency rows,
    exchange back, merge cached rows in, and admit the miss responses.

    pivots/need: (nloc, cap).  Returns ``(req_ids (nloc, ndev, fcap) sorted
    per peer — hits included, fetched_adj (nloc, ndev, fcap, max_degree)
    with cached rows merged in, overflow, fstats, cache')``.  ``fstats``
    counts only what crossed the wire in ``bytes_fetch``; the hit-masked
    remainder is ``bytes_saved_cache``.

    With ``exch.wire_format == "varint"`` the hole-masked request lanes go
    out delta+varint coded, the owners answer with degree+delta coded row
    streams, and the requesters decode them and scatter the compacted rows
    back onto their hole positions: the rows are bit-identical to the raw
    path's, and only ``bytes_wire_fetch`` (the stream lengths) changes."""
    ndev, stride, n, D = g.ndev, g.stride, g.n, g.max_degree
    dev0, nloc = g.dev0, g.nloc
    use_cache = cache is not None
    t2 = _dev_ids(dev0, dev0 + nloc, pivots.device, 2)
    foreign = need & (pivots // stride != t2) & (pivots < n)
    uids, umask = unique_ids(pivots, foreign, n)
    owners = (uids // stride).clamp(0, ndev - 1)
    reqs, counts, ovs = _per_peer_compact(uids, umask, owners, ndev, fcap, n)
    if use_cache:
        # the reference probes every unique id, then compacts the outcomes;
        # probing the compacted requests gives the same flags, ways and
        # rows (a sentinel slot misses with way 0 and a sentinel row) for
        # (nloc, ndev, fcap) ids instead of (nloc, frontier_cap)
        hit_c, slot_c, way_c = probe_lines(cache.keys, reqs.view(nloc, -1),
                                           n)
        hit_c = hit_c.view(reqs.shape)
        # hits never cross the wire: mask them out of the request
        wire = reqs.masked_fill(hit_c, n)
        counts_hit = hit_c.sum(-1)
    else:
        wire = reqs
        counts_hit = torch.zeros_like(counts)

    # The response rows are the one large tensor here, (nloc, ndev, fcap,
    # max_degree).  It is built once, in the requesters' layout: owners
    # answer in device chunks whose exchange lands in its slice, and the
    # cached rows of hits are merged in place, chunk by chunk.  A rank
    # holding one machine is one responder: one chunk, a whole exchange.
    fetched = torch.empty(reqs.shape + (D,), dtype=torch.int32,
                          device=reqs.device)           # (nloc, peer, fcap, D)
    chunks = (_device_chunks(nloc, ndev * fcap * D) if exch.whole_stack
              else [(0, nloc)])

    def peers(p0: int, p1: int) -> slice:
        """The requesters' peer slots a responder chunk's exchange fills."""
        return slice(p0, p1) if exch.whole_stack else slice(None)

    model_ids = None
    wire_ov = torch.zeros((), dtype=torch.bool, device=reqs.device)
    if exch.wire_format == "varint":
        # coded path: compacted varint id streams out, degree+delta coded
        # row streams back, decoded and scattered onto the requesters' hole
        # positions one responder chunk at a time
        req_cap, degs_cap, rows_cap = wire_codec.fetch_stream_caps(fcap, D)
        req_s, req_len, req_raw, e_ov, model_ids = \
            wire_codec.encode_ids_lanes(wire, n, req_cap)
        recv_s, recv_len, recv_raw = exch.a2a_tree((req_s, req_len, req_raw))
        dec_ids, dec_mask = wire_codec.decode_ids_lanes(
            recv_s, recv_len, recv_raw, fcap, n)        # (nloc, src, fcap)
        del req_s, recv_s
        resp_len = torch.empty_like(req_len)    # row stream bytes, [p, t]
        for p0, p1 in chunks:
            resp = _fetch_answer(g, dec_ids[p0:p1], dev0 + p0)
            dg_s, dg_len, ri_s, ri_len, resp_raw, r_ov = \
                wire_codec.encode_rows_lanes(resp, dec_mask[p0:p1], n,
                                             degs_cap, rows_cap)
            del resp
            # decoded straight onto the requesters' slots of this chunk
            wire_codec.decode_rows_lanes(
                *exch.a2a_tree((dg_s, dg_len, ri_s, ri_len, resp_raw)),
                fcap, D, n, valid=wire[:, peers(p0, p1)] < n,
                out=fetched[:, peers(p0, p1)])          # (nloc, d, fcap, D)
            del dg_s, ri_s
            resp_len[p0:p1] = dg_len + ri_len
            wire_ov = wire_ov | r_ov
        wire_ov = wire_ov | e_ov
    else:
        recv = exch.a2a(wire)                           # (nloc, src, fcap)
        for p0, p1 in chunks:
            fetched[:, peers(p0, p1)] = exch.a2a(
                _fetch_answer(g, recv[p0:p1], dev0 + p0))
    if use_cache:
        for t0, t1 in _device_chunks(nloc, ndev * fcap * D):
            f = fetched[t0:t1]
            i2 = torch.arange(t0, t1, device=f.device)[:, None]
            crow = cache.rows[i2, slot_c[t0:t1], way_c[t0:t1]].view(f.shape)
            torch.where(hit_c[t0:t1, ..., None], crow, f, out=f)
        # the admission pass over this batch's probe outcomes
        cache = cache.updated(reqs.view(nloc, -1), hit_c.view(nloc, -1),
                              way_c.to(torch.int32),
                              fetched.view(nloc, -1, D))

    # the modeled column reuses the codec's sizing pass when it already ran
    if model_ids is None:
        model_ids = _varint_id_bytes(wire, n)
    lens = (req_len, resp_len) if exch.wire_format == "varint" else ()
    # every machine's per-peer matrices, (ndev, ndev): the stats below are
    # sim's own arithmetic on them
    counts, counts_hit, model_ids, *lens = exch.gather_rows(
        counts, counts_hit, model_ids, *lens)
    # 4B request id + 4B * max_degree response row per off-device entry
    elem = 4 * (1 + D)
    eff = counts - counts_hit                    # entries that cross the wire
    full_bytes = exch.off_device_bytes(counts, elem)
    wire_bytes = exch.off_device_bytes(eff, elem)
    if lens:
        req_len, resp_len = lens
        wire_stream_bytes = (exch.off_device_payload_bytes(req_len)
                             + exch.off_device_payload_bytes(resp_len))
        # requesters send the id streams, responders the row streams: the
        # row sums recover wire_stream_bytes exactly
        wire_dev = (exch.per_dev_sent_bytes(req_len)
                    + exch.per_dev_sent_bytes(resp_len))
    else:
        # requester t sends 4B ids (eff[t, p]), responder p sends 4*D-byte
        # rows back (eff.T); the two row sums add up to wire_bytes exactly
        wire_dev = (exch.per_dev_sent_bytes(eff * 4.0)
                    + exch.per_dev_sent_bytes(eff.T * (4.0 * D)))
        wire_stream_bytes = wire_bytes
    comp_bytes = (exch.off_device_payload_bytes(model_ids)
                  + exch.off_device_bytes(eff, 4.0 * D))
    zero = torch.zeros((), dtype=torch.float32, device=pivots.device)
    fstats = dict(
        bytes_fetch=wire_bytes,
        bytes_fetch_compressed=comp_bytes,
        # stream lengths under 'varint', the raw accounting under 'raw'
        bytes_wire_fetch=wire_stream_bytes,
        bytes_wire_fetch_dev=wire_dev,
        bytes_saved_cache=full_bytes - wire_bytes,
        # probe/hit counters exist only when there is a cache to probe
        cache_hits=counts_hit.sum().to(torch.float32) if use_cache else zero,
        cache_probes=counts.sum().to(torch.float32) if use_cache else zero)
    return reqs, fetched, ovs | wire_ov, fstats, cache


def _fetch_answer(g: DeviceGraph, rc, p0: int):
    """Owner-side fetchV answer of the machines ``p0..`` (global ids,
    inside the graph's block): the local adjacency
    row of each requested id ``rc (d, src, fcap)``, sentinel rows where the
    id is not local."""
    stride, n = g.stride, g.n
    t3 = _dev_ids(p0, p0 + rc.shape[0], rc.device, 3)
    ok = (rc // stride == t3) & (rc < n)
    resp = g.rows_at((rc - t3 * stride).clamp(0, stride - 1), p0)
    return resp.masked_fill_(~ok[..., None], n)


def verify_exchange(g: DeviceGraph, exch: ExchangeBackend, pa, pb, pmask,
                    vcap: int):
    """Batched verifyE over the EVI (§3.2).  pa/pb/pmask: (nloc, R, K).
    Pairs are routed to owner(pa).  Returns ``(ok (nloc, R, K) — True
    where the edge exists or the slot is inactive, overflow, off_bytes,
    wire_bytes, wire_dev)``.  ``off_bytes`` is the raw-equivalent
    accounting (8 B per pair + 1 B per answer); ``wire_bytes`` is what
    crossed: equal to it on the raw wire, the coded stream lengths on the
    varint wire (Elias-Fano ``a``, run-delta varint ``b``, bit-packed
    answers).  ``wire_dev`` attributes ``wire_bytes`` to the sending
    devices."""
    ndev, stride, n, nloc = g.ndev, g.stride, g.n, g.nloc
    R, K = pa.shape[1], pa.shape[2]
    fa, fb, fm = (x.reshape(nloc, R * K) for x in (pa, pb, pmask))

    ua, ub, umask, rank = unique_pairs(fa, fb, fm, n)
    owners = (ua // stride).clamp(0, ndev - 1)
    reqs_a, reqs_b, counts, ov = _per_peer_compact(
        ua, umask, owners, ndev, vcap, n, extras=((ub, n),))
    # uniques sorted by `a` => owners non-decreasing => peers contiguous;
    # slot inside a peer block = index - first index of that owner
    start = torch.searchsorted(owners, owners)
    slots = torch.arange(owners.shape[1], device=owners.device) - start

    def answer(ra, rb):
        return torch.cat([
            _verify_answer(g, ra[t0:t1], rb[t0:t1], g.dev0 + t0)
            for t0, t1 in _device_chunks(nloc, ndev * vcap * g.max_degree)])

    if exch.wire_format == "varint":
        # coded path: EF(a) + run-delta varint(b) out, bit-packed bools back
        a_cap, b_cap, ans_cap = wire_codec.verify_stream_caps(vcap)
        a_s, a_len, b_s, b_len, p_raw, p_ov = wire_codec.encode_pairs_lanes(
            reqs_a, reqs_b, n, a_cap, b_cap)
        ra_s, ra_len, rb_s, rb_len, r_raw, r_counts = exch.a2a_tree(
            (a_s, a_len, b_s, b_len, p_raw, counts))
        dec_a, dec_b, _ = wire_codec.decode_pairs_lanes(
            ra_s, ra_len, rb_s, rb_len, r_raw, r_counts, vcap, n, n)
        ans_s, ans_len = wire_codec.pack_bools_lanes(answer(dec_a, dec_b),
                                                     r_counts, ans_cap)
        back = wire_codec.unpack_bools_lanes(exch.a2a(ans_s), counts, vcap)
        lens = (a_len + b_len, ans_len)
        ov = ov | p_ov
    else:
        recv_a, recv_b = exch.a2a_tree((reqs_a, reqs_b))
        back = exch.a2a(answer(recv_a, recv_b))         # (nloc, peer, vcap)
        lens = ()

    t2 = torch.arange(nloc, device=owners.device)[:, None]
    sl_c = slots.clamp(0, vcap - 1)
    ok_unique = back[t2, owners, sl_c] & umask & (slots < vcap)
    ok_flat = ok_unique.gather(1, rank.long().clamp_(0, R * K - 1))
    ok = ok_flat.view(nloc, R, K) | ~pmask
    # every machine's per-peer matrices, (ndev, ndev), as in fetch_exchange
    counts, *lens = exch.gather_rows(counts, *lens)
    off_bytes = exch.off_device_bytes(counts, 8 + 1)
    if lens:
        wire_bytes = (exch.off_device_payload_bytes(lens[0])
                      + exch.off_device_payload_bytes(lens[1]))
        wire_dev = (exch.per_dev_sent_bytes(lens[0])
                    + exch.per_dev_sent_bytes(lens[1]))
    else:
        wire_bytes = off_bytes
        # requester t sends 8B pairs (counts[t, p]); owner p sends 1B
        # answers back (counts.T) — row sums add up to off_bytes exactly
        wire_dev = (exch.per_dev_sent_bytes(counts * 8.0)
                    + exch.per_dev_sent_bytes(counts.T * 1.0))
    return ok, ov, off_bytes, wire_bytes, wire_dev


def _verify_answer(g: DeviceGraph, ra, rb, t0: int):
    """Owner-side verifyE answer of the machines ``t0..`` (global ids):
    is ``rb`` in the
    local adjacency row of ``ra``?  ``ra``/``rb``: (d, src, vcap)."""
    stride, n, D = g.stride, g.n, g.max_degree
    t3 = _dev_ids(t0, t0 + ra.shape[0], ra.device, 3)
    li = (ra - t3 * stride).clamp(0, stride - 1)
    local_ok = (ra // stride == t3) & (ra < n)
    rows = g.rows_at(li, t0)                            # (d, src, vcap, D)
    memb = membership(rows.view(-1, D), rb.reshape(-1, 1)).view(rb.shape)
    return memb & local_ok


# --------------------------------------------------------------------------- #
# Leaf expansion
# --------------------------------------------------------------------------- #
def _leaf_step(g: DeviceGraph, cfg: EngineConfig, spec: StepSpec,
               k_off: int, rows, alive, seed_slot,
               pend_a, pend_b, pend_m, req_ids, fetched, local_only: bool):
    """Expand one leaf on every device: candidates = adj(pivot); filter
    (injectivity, symmetry, degree, local back-edge membership — Alg.
    1+2); compact to ``frontier_cap``; record undetermined edges into the
    pending (EVI) buffers.  Runs the devices in memory-bounded chunks."""
    outs = [_leaf_devs(g, cfg, spec, k_off, g.dev0 + t0, rows[t0:t1],
                       alive[t0:t1],
                       seed_slot[t0:t1], pend_a[t0:t1], pend_b[t0:t1],
                       pend_m[t0:t1],
                       None if local_only else req_ids[t0:t1],
                       None if local_only else fetched[t0:t1], local_only)
            for t0, t1 in _device_chunks(g.nloc,
                                         rows.shape[1] * g.max_degree)]
    if len(outs) == 1:
        return outs[0]
    return (*(torch.cat(parts) for parts in zip(*(o[:6] for o in outs))),
            torch.stack([o[6] for o in outs]).any(),
            torch.stack([o[7] for o in outs]).any())


def _leaf_devs(g: DeviceGraph, cfg: EngineConfig, spec: StepSpec,
               k_off: int, t0: int, rows, alive, seed_slot,
               pend_a, pend_b, pend_m, req_ids, fetched, local_only: bool):
    """:func:`_leaf_step` for the machines ``t0..t0+d-1`` (global ids;
    the slices passed in)."""
    ndev, stride, n, D = g.ndev, g.stride, g.n, g.max_degree
    cap = cfg.frontier_cap
    d, R, w = rows.shape
    dev = rows.device
    t2 = _dev_ids(t0, t0 + d, dev, 2)      # global ids: ownership tests
    t3 = _dev_ids(t0, t0 + d, dev, 3)
    i2 = torch.arange(d, device=dev)[:, None]   # local ids: indexing

    pv = rows[:, :, spec.piv_col]
    is_local = (pv // stride == t2) & (pv < n)
    cand = g.rows_at((pv - t2 * stride).clamp(0, stride - 1), t0)   # (d,R,D)
    if local_only:
        cand.masked_fill_(~is_local[..., None], n)
        lost = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        fcap = req_ids.shape[2]
        peer = (pv // stride).clamp(0, ndev - 1).long()
        # searchsorted of pv in its peer's sorted request row, done for all
        # peers at once: offsetting each peer's ids by peer * (n + 1) makes
        # the concatenated rows one sorted sequence per device
        key = (req_ids.long()
               + torch.arange(ndev, device=dev).view(1, ndev, 1) * (n + 1))
        pos = torch.searchsorted(key.view(d, -1),
                                 peer * (n + 1) + pv.long())
        slot = (pos - peer * fcap).clamp_(0, fcap - 1)
        hit = req_ids[i2, peer, slot] == pv
        frow = fetched[i2, peer, slot].masked_fill_(~hit[..., None], n)
        torch.where(is_local[..., None], cand, frow, out=cand)  # (d, R, D)
        del frow
        lost = (alive & (pv < n) & ~is_local & ~hit).any()

    valid = (cand < n) & alive[..., None]
    for c in range(w):                                     # injectivity
        valid &= cand != rows[:, :, c, None]
    for c in spec.sym_lt_cols:                             # symmetry breaking
        valid &= rows[:, :, c, None] < cand
    for c in spec.sym_gt_cols:
        valid &= cand < rows[:, :, c, None]
    # ownership by range compare: a floor division would build one more
    # full-size int32 tensor
    c_local = (cand >= t3 * stride) & (cand < (t3 + 1) * stride) & (cand < n)
    valid &= ~c_local | (g.deg_at((cand - t3 * stride).clamp_(0, stride - 1),
                                  t0) >= spec.leaf_deg)
    if local_only:
        valid &= c_local                                   # Prop. 1 pruning
    del c_local
    for c in spec.back_cols:           # local checks (Alg 2 lines 3-5, 8-11)
        wv = rows[:, :, c]
        w_loc = (wv // stride == t2) & (wv < n)
        w_row = g.rows_at((wv - t2 * stride).clamp(0, stride - 1), t0)
        memb = _backedge_mask(g, w_row.view(-1, D), cand.view(-1, D)
                              ).view(cand.shape)
        del w_row
        valid &= ~w_loc[..., None] | memb
        del memb

    # compact (R*D) -> cap
    new_mask, ov, take = compact_index(valid.view(d, R * D), cap)
    del valid
    parent_c = masked(take // D, new_mask, 0)
    cand_c = masked(cand.view(d, R * D).gather(1, take), new_mask, 0)
    del cand
    new_rows = masked(torch.cat([rows[i2, parent_c], cand_c[..., None]],
                                dim=2), new_mask, n)
    new_slot = masked(seed_slot[i2, parent_c], new_mask, 0)
    pa_n, pb_n = pend_a[i2, parent_c], pend_b[i2, parent_c]
    pm_n = pend_m[i2, parent_c] & new_mask[..., None]

    # new pending pairs: back edges whose f(u') is foreign.  Route to the
    # local endpoint if the candidate is local (paper: verify locally),
    # else to owner(f(u')).
    for k, c in enumerate(spec.back_cols):
        wv_n = new_rows[:, :, c]
        cd = new_rows[:, :, -1]
        w_loc_n = (wv_n // stride == t2) & (wv_n < n)
        c_loc_n = (cd // stride == t2) & (cd < n)
        need = new_mask & ~w_loc_n
        a_val = torch.where(c_loc_n, cd, wv_n)
        b_val = torch.where(c_loc_n, wv_n, cd)
        pa_n[:, :, k_off + k] = masked(a_val, need, n)
        pb_n[:, :, k_off + k] = masked(b_val, need, n)
        pm_n[:, :, k_off + k] = need
    return (new_rows, new_mask, new_slot, pa_n, pb_n, pm_n, ov.any(), lost)


# --------------------------------------------------------------------------- #
# WaveState: the per-wave state threaded through the stages
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class WaveState:
    """Everything one region-group wave carries between pipeline stages.

    ``rows`` widens by one column per leaf step.  ``pend_*`` (the EVI
    buffers, Def. 5) exist only on the expand→verify edge and are ``None``
    elsewhere; ``rounds_alive`` grows by one per-device count per unit.

    Byte counters are f32 scalars, as in the reference, exact up to 2^24
    bytes *per wave*; the driver accumulates waves in Python floats."""

    rows: torch.Tensor           # (nloc, cap, width) partial embeddings
    alive: torch.Tensor          # (nloc, cap) bool
    seed_slot: torch.Tensor      # (nloc, cap) originating seed slot
    overflow: torch.Tensor       # () bool — any capacity overflow so far
    lost: torch.Tensor           # () bool — any dropped fetchV response
    bytes_fetch: torch.Tensor    # () f32 — off-device fetchV wire traffic
    bytes_verify: torch.Tensor   # () f32 — off-device verifyE traffic
    bytes_wire_fetch: torch.Tensor   # () f32 — fetchV bytes on the wire
    bytes_wire_verify: torch.Tensor  # () f32 — verifyE bytes on the wire
    bytes_wire_fetch_dev: torch.Tensor   # (ndev,) f32 — by sending device
    bytes_wire_verify_dev: torch.Tensor  # (ndev,) f32 — by sending device
    bytes_fetch_compressed: torch.Tensor  # () f32 — modeled delta+varint
    bytes_saved_cache: torch.Tensor       # () f32 — fetchV bytes hit-masked
    cache_hits: torch.Tensor     # () f32 — unique foreign ids served by cache
    cache_probes: torch.Tensor   # () f32 — unique foreign ids requested
    node_counts: torch.Tensor    # (nloc, scap) trie nodes per seed
    rounds_alive: tuple = ()     # per-unit (nloc,) alive counts
    pend_a: torch.Tensor | None = None   # (nloc, cap, K) EVI endpoint a
    pend_b: torch.Tensor | None = None   # (nloc, cap, K) EVI endpoint b
    pend_m: torch.Tensor | None = None   # (nloc, cap, K) EVI slot active


def init_wave(g: DeviceGraph, seeds, seed_mask) -> WaveState:
    """Stage 0: lift the graph's block of rows of a padded (ndev, scap)
    seed block into a WaveState."""
    dev = g.device
    part = slice(g.dev0, g.dev0 + g.nloc)
    # pinned host buffers let the copies run behind the queued work
    # instead of synchronising the stream
    seeds = _to_device(np.asarray(seeds, dtype=np.int32)[part], dev)
    seed_mask = _to_device(np.asarray(seed_mask, dtype=np.bool_)[part], dev)
    nloc, scap = seeds.shape
    ndev = g.ndev
    f32 = dict(dtype=torch.float32, device=dev)
    return WaveState(
        rows=seeds[..., None],
        alive=seed_mask,
        seed_slot=torch.arange(scap, dtype=torch.int32, device=dev)
        .expand(nloc, scap).contiguous(),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
        lost=torch.zeros((), dtype=torch.bool, device=dev),
        bytes_fetch=torch.zeros((), **f32),
        bytes_verify=torch.zeros((), **f32),
        bytes_wire_fetch=torch.zeros((), **f32),
        bytes_wire_verify=torch.zeros((), **f32),
        bytes_wire_fetch_dev=torch.zeros((ndev,), **f32),
        bytes_wire_verify_dev=torch.zeros((ndev,), **f32),
        bytes_fetch_compressed=torch.zeros((), **f32),
        bytes_saved_cache=torch.zeros((), **f32),
        cache_hits=torch.zeros((), **f32),
        cache_probes=torch.zeros((), **f32),
        node_counts=torch.zeros((nloc, scap), dtype=torch.int32, device=dev))


def unit_evi_width(pd: PlanData, ui: int) -> int:
    """Number of EVI slots unit ``ui`` can emit (0 => verifyE is a no-op)."""
    return sum(len(pd.steps[s].back_cols) for s in pd.unit_steps[ui])


def fetch_stage(g: DeviceGraph, pd: PlanData, cfg: EngineConfig,
                exch: ExchangeBackend, ui: int, state: WaveState,
                local_only: bool, cache: AdjCache | None = None):
    """Pipeline stage 1 of unit ``ui``: batched fetchV on the unit pivot,
    with the adjacency cache probed before and fed after the exchange.

    Returns ``(state', bufs, cache')`` where ``bufs = (req_ids, fetched)``
    feeds ``expand_stage`` (``None`` in SM-E mode)."""
    if local_only:
        return state, None, cache
    piv_col = pd.unit_piv_cols[ui]
    req_ids, fetched, f_ov, fs, cache = fetch_exchange(
        g, exch, state.rows[:, :, piv_col], state.alive, cfg.fetch_cap, cache)
    state = replace(
        state, overflow=state.overflow | f_ov,
        bytes_fetch=state.bytes_fetch + fs["bytes_fetch"],
        bytes_wire_fetch=state.bytes_wire_fetch + fs["bytes_wire_fetch"],
        bytes_wire_fetch_dev=(state.bytes_wire_fetch_dev
                              + fs["bytes_wire_fetch_dev"]),
        bytes_fetch_compressed=(state.bytes_fetch_compressed
                                + fs["bytes_fetch_compressed"]),
        bytes_saved_cache=state.bytes_saved_cache + fs["bytes_saved_cache"],
        cache_hits=state.cache_hits + fs["cache_hits"],
        cache_probes=state.cache_probes + fs["cache_probes"])
    return state, (req_ids, fetched), cache


def expand_stage(g: DeviceGraph, pd: PlanData, cfg: EngineConfig,
                 ui: int, state: WaveState, bufs, local_only: bool
                 ) -> WaveState:
    """Pipeline stage 2 of unit ``ui``: every leaf step of the unit, and
    EVI recording into fresh ``pend_*`` buffers."""
    scap = state.node_counts.shape[1]
    K = max(unit_evi_width(pd, ui), 1)
    rows, alive, seed_slot = state.rows, state.alive, state.seed_slot
    overflow, lost, node_counts = state.overflow, state.lost, state.node_counts
    shape = (rows.shape[0], rows.shape[1], K)
    pend_a = torch.full(shape, g.n, dtype=torch.int32, device=rows.device)
    pend_b = torch.full(shape, g.n, dtype=torch.int32, device=rows.device)
    pend_m = torch.zeros(shape, dtype=torch.bool, device=rows.device)
    req_ids, fetched = bufs if bufs is not None else (None, None)
    k_off = 0
    for sid in pd.unit_steps[ui]:
        spec = pd.steps[sid]
        (rows, alive, seed_slot, pend_a, pend_b, pend_m, ov_s, lost_s
         ) = _leaf_step(g, cfg, spec, k_off,
                        rows, alive, seed_slot, pend_a, pend_b, pend_m,
                        req_ids, fetched, local_only)
        overflow = overflow | ov_s
        lost = lost | lost_s
        k_off += len(spec.back_cols)
        # many frontier rows per seed: an integer segment-sum per seed slot
        node_counts = node_counts.scatter_add(
            1, seed_slot.clamp(0, scap - 1).long(), alive.to(torch.int32))
    return replace(state, rows=rows, alive=alive, seed_slot=seed_slot,
                   overflow=overflow, lost=lost, node_counts=node_counts,
                   pend_a=pend_a, pend_b=pend_b, pend_m=pend_m)


def verify_stage(g: DeviceGraph, pd: PlanData, cfg: EngineConfig,
                 exch: ExchangeBackend, ui: int, state: WaveState,
                 local_only: bool) -> WaveState:
    """Pipeline stage 3 of unit ``ui``: batched verifyE over the EVI, then
    alive-masking.  Consumes the ``pend_*`` buffers and appends the unit's
    per-device alive count to ``rounds_alive``."""
    alive = state.alive
    overflow, bytes_verify = state.overflow, state.bytes_verify
    bytes_wire_verify = state.bytes_wire_verify
    bytes_wire_verify_dev = state.bytes_wire_verify_dev
    if (not local_only) and unit_evi_width(pd, ui) > 0:
        ok, v_ov, v_b, v_wb, v_wd = verify_exchange(
            g, exch, state.pend_a, state.pend_b, state.pend_m,
            cfg.verify_cap)
        alive = alive & ok.all(dim=-1)
        overflow = overflow | v_ov
        bytes_verify = bytes_verify + v_b
        bytes_wire_verify = bytes_wire_verify + v_wb
        bytes_wire_verify_dev = bytes_wire_verify_dev + v_wd
    return replace(state, alive=alive, overflow=overflow,
                   bytes_verify=bytes_verify,
                   bytes_wire_verify=bytes_wire_verify,
                   bytes_wire_verify_dev=bytes_wire_verify_dev,
                   rounds_alive=state.rounds_alive + (alive.sum(dim=-1),),
                   pend_a=None, pend_b=None, pend_m=None)


def finalize_wave(state: WaveState, exec_hits=0.0):
    """Drain point: WaveState -> the ``(rows, alive, counts, complete,
    stats)`` tuple the driver consumes.  ``exec_hits``, the stage
    executables this wave's dispatches resolved from the persistent
    store (a float, or a 0-d f32 tensor as a stage graph takes it),
    rides along as ``stats["compile_cache_hits"]`` to the single retire
    copy."""
    counts = state.alive.sum(dim=-1)
    if not isinstance(exec_hits, torch.Tensor):
        # a fill, not a copy of a host value: nothing waits on the host
        exec_hits = torch.full((), float(exec_hits), dtype=torch.float32,
                               device=counts.device)
    stats = dict(bytes_fetch=state.bytes_fetch,
                 bytes_verify=state.bytes_verify,
                 bytes_wire_fetch=state.bytes_wire_fetch,
                 bytes_wire_verify=state.bytes_wire_verify,
                 bytes_wire_fetch_dev=state.bytes_wire_fetch_dev,
                 bytes_wire_verify_dev=state.bytes_wire_verify_dev,
                 bytes_fetch_compressed=state.bytes_fetch_compressed,
                 bytes_saved_cache=state.bytes_saved_cache,
                 cache_hits=state.cache_hits,
                 cache_probes=state.cache_probes,
                 compile_cache_hits=exec_hits,
                 rows_per_round=torch.stack(state.rounds_alive),
                 node_counts=state.node_counts)
    return (state.rows, state.alive, counts,
            ~(state.overflow | state.lost), stats)


# --------------------------------------------------------------------------- #
# Full multi-round run (synchronous composition of the stages)
# --------------------------------------------------------------------------- #
def run_rounds(g: DeviceGraph, pd: PlanData, cfg: EngineConfig,
               exch: ExchangeBackend, seeds, seed_mask, local_only: bool,
               cache: AdjCache | None = None):
    """All units, all leaves, exchanges per round: ``fetch→expand→verify``
    per unit, with the (optional) adjacency cache threaded through the
    fetches and discarded at the end.  Returns ``finalize_wave``'s tuple."""
    state = init_wave(g, seeds, seed_mask)
    for ui in range(len(pd.unit_steps)):
        state, bufs, cache = fetch_stage(g, pd, cfg, exch, ui, state,
                                         local_only, cache)
        state = expand_stage(g, pd, cfg, ui, state, bufs, local_only)
        state = verify_stage(g, pd, cfg, exch, ui, state, local_only)
    return finalize_wave(state)
