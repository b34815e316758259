"""On-the-wire codecs for the exchange payloads, and wire-format selection
(the port of the reference's ``core/wire.py``).

With ``wire_format="varint"`` the engine encodes every exchange payload
lane into a compact ``uint8`` stream, the streams (plus per-lane byte
lengths) travel through the exchange, and the receiving device decodes
them back.  ``encode ∘ decode`` is exact, so enumeration results do not
depend on the wire format.  Every stream, length, raw flag and overflow
flag equals the reference's byte for byte.

Stream layout
-------------
A *lane* is one (source device, peer device) payload of a batched exchange.
Every codec is fixed-capacity: a lane encodes into a ``cap``-byte buffer
plus a byte ``length`` (the only bytes a real transport would send; the
accounting sums lengths, never capacities).

* **fetchV request ids** (:func:`encode_ids` / :func:`decode_ids`) —
  sorted-unique ids with sentinel holes (cache hits are masked off the
  wire).  The holes are dropped; valid ids are delta-coded against the
  previous valid id (the first absolute) and each delta LEB128-coded (7
  payload bits per byte, high bit = continuation).  The requester
  scatters the positional responses back (:func:`scatter_compacted`).
* **fetchV response rows** (:func:`encode_rows` / :func:`decode_rows`) —
  a varint *degree* stream (one value per valid row) and a flat varint
  *id* stream (per row: first neighbour absolute, then deltas).
* **verifyE pairs** (:func:`encode_pairs` / :func:`decode_pairs`) — the
  monotone ``a`` column Elias-Fano coded (``l`` low bits packed, high
  bits in unary, ``l`` derived from (universe, count) by integer
  bit-length arithmetic), the ``b`` column varint coded, absolute at the
  start of each equal-``a`` run and delta inside it.  The pair count
  rides the exchange's ``counts`` matrix.
* **verifyE answers** (:func:`pack_bools` / :func:`unpack_bools`) — one
  bit per queried pair.

Each encoder also forms the lane in raw little-endian ``int32`` and keeps
whichever is smaller (the per-lane ``raw`` flag), so wire bytes never
exceed the raw accounting.  Stream capacities derive from the engine
capacities (:func:`fetch_stream_caps`, :func:`verify_stream_caps`) and
escalate with them; the ``overflow`` flags feed the scheduler's
split/escalate loop.

How the port computes them
--------------------------
Every codec works on a batch of lanes ``(L, ...)`` at once.  The fetch
path's three codecs (request ids out, response rows out, response rows
back) are :mod:`repro_torch.kernels.varint.ops`: on the card, hand-written
CUDA kernels that take every lane of a call in one launch, read only the
live ids, rows and bytes, and write each output byte once (the row
decoder straight onto the requester's slots); on the CPU, their plain
versions (:mod:`repro_torch.kernels.varint.ref`), which the lane wrappers
run in groups of at most :data:`CODEC_CHUNK_ELEMS` payload elements,
because at the escalated fetch capacity one response lane alone is
4 · 1,780 · 32,768 bytes.  The request id decoder and the verifyE codecs
are plain PyTorch on both paths, grouped the same way; they share the
plain versions' byte-level helpers (dropped writes, LEB128 write and
parse, raw int32 words).  Bit ORs are accumulated in int32 and cast to
``uint8`` once; running sums along a lane go through one flat scan
(:func:`repro_torch.core.exchange.row_cumsum`) and keep the reference's
int32 wrap-around.
"""
from __future__ import annotations

import torch

from repro_torch.core.exchange import row_cumsum
# module objects, not names: the plain versions' module imports
# core.exchange, so this module may be imported while it is half done
from repro_torch.kernels.varint import ops as varint_ops
from repro_torch.kernels.varint import ref as vref

_U8 = torch.uint8
_I32 = torch.int32

# The lane wrappers run at most this many payload elements (ids or stream
# bytes of a lane, whichever is larger) through a plain codec at once;
# each element takes a few tens of bytes of temporaries.
CODEC_CHUNK_ELEMS = 1 << 26


# --------------------------------------------------------------------------- #
# Capacity helpers (derived from the engine caps => escalate together)
# --------------------------------------------------------------------------- #
def fetch_stream_caps(fcap: int, max_degree: int) -> tuple[int, int, int]:
    """(request id stream, response degree stream, response id stream) caps.

    Sized so the raw escape always fits: requests <= 4 B/id, responses
    <= 4·max_degree B/row; the coded form is only selected when smaller.
    """
    return 4 * fcap, 2 * fcap, 4 * max_degree * fcap


def verify_stream_caps(vcap: int) -> tuple[int, int, int]:
    """(a stream, b stream, answer stream) caps — raw escape fits 4 B/id
    per column; answers are bit-packed (always <= 1 B/pair)."""
    return 4 * vcap, 4 * vcap, (vcap + 7) // 8


# --------------------------------------------------------------------------- #
# Byte-level helpers over a batch of lanes (L, ...); the shared ones live
# beside the fetch codec's plain versions (kernels/varint/ref.py)
# --------------------------------------------------------------------------- #
def _get_bit(stream: torch.Tensor, bitpos: torch.Tensor) -> torch.Tensor:
    cap = stream.shape[1]
    byte = torch.gather(stream, 1, (bitpos >> 3).clamp(0, cap - 1).long())
    return (byte.to(_I32) >> (bitpos & 7)) & 1


def _last_true(flag: torch.Tensor) -> torch.Tensor:
    """For each position, the index of the last True at or before it
    along the lane (-1 if none) — a running max over the flagged indices,
    built from a running count and one scatter."""
    L, m = flag.shape
    cs = row_cumsum(flag)
    at = vref.scatter_drop((L, m), cs - 1, flag,
                       vref.arange(m, flag).expand(L, m), _I32)
    last = torch.gather(at, 1, (cs - 1).clamp_(min=0).long())
    return last.masked_fill_(cs == 0, -1)


def _bitlen(x: torch.Tensor) -> torch.Tensor:
    """Integer bit length of int32 ``x`` (floor(log2(x)) + 1 for x > 0; 0
    for x <= 0) — pure integer compares, so encoder and decoder always
    agree."""
    out = torch.zeros_like(x, dtype=_I32)
    for k in range(31):
        out += x >= (1 << k)
    return out


def _ef_lowbits(universe: int, count: torch.Tensor) -> torch.Tensor:
    """EF low-bit width ~ floor(log2(universe / count)), integerized.  The
    universe's bit length is taken on the host: a host scalar copied to
    the card would synchronise the stream."""
    u = max(int(universe), 0).bit_length()
    return (u - _bitlen(count.clamp(min=1))).clamp_(0, 30)


# --------------------------------------------------------------------------- #
# Batched codecs: every argument carries a leading lane axis L
# --------------------------------------------------------------------------- #
def _decode_ids(stream, length, raw, m_out: int, sentinel: int):
    deltas, count_c = vref.parse_varints(stream, length, m_out)
    ids_c = row_cumsum(deltas)
    ids_r = vref.read_raw32(stream, m_out)
    count = torch.where(raw, length // 4, count_c)
    mask = vref.arange(m_out, stream) < count[:, None]
    ids = torch.where(raw[:, None], ids_r, ids_c).masked_fill_(~mask,
                                                               sentinel)
    return ids, mask


def _encode_pairs(a, b, universe: int, a_cap: int, b_cap: int):
    L, m = a.shape
    idx = vref.arange(m, a)
    # only ids in [0, universe) are coded: a stage must run without a
    # fault on any argument values (see repro_torch.core.scheduler), and
    # a negative a would set a bit at a negative scatter index below
    valid = (a >= 0) & (a < universe)
    count = valid.sum(-1, dtype=_I32)
    l = _ef_lowbits(universe, count)[:, None]

    # -- a column: Elias-Fano (low bits packed, high bits in unary) -------- #
    av = a.masked_fill(~valid, 0)
    bits = torch.zeros((L, a_cap + m), dtype=_I32, device=a.device)

    def set_bits(bitpos, bit, sel):
        byte = bitpos >> 3
        keep = sel & (bit > 0) & (byte < a_cap)
        bits.scatter_add_(1, vref.drop_index(byte, keep, a_cap),
                          bit << (bitpos & 7))

    for j in range(31):
        set_bits(idx * l + j, (av >> j) & 1, valid & (j < l))
    high = av >> l
    set_bits(count[:, None] * l + high + idx, torch.ones_like(av), valid)
    a_s = bits[:, :a_cap].to(_U8)
    del bits
    last_high = high.masked_fill(~valid, -1).amax(-1)
    a_bits = count * l[:, 0] + torch.where(count > 0, last_high + count, 0)
    a_total = (a_bits + 7) // 8

    # -- b column: varint, absolute at run starts, delta inside runs ------- #
    prev_a = torch.cat([a.new_full((L, 1), -1), a[:, :-1]], dim=1)
    prev_b = torch.cat([b.new_zeros((L, 1)), b[:, :-1]], dim=1)
    bv = torch.where(a != prev_a, b, (b - prev_b).clamp_(min=0))
    bv.masked_fill_(~valid, 0)
    bvl = vref.varint_size(bv).masked_fill_(~valid, 0)
    b_s, b_total = vref.write_varints(bv, bvl, b_cap)

    raw_len = 4 * count
    use_raw = ((a_total + b_total > 2 * raw_len) | (a_total > a_cap)
               | (b_total > b_cap))
    u = use_raw[:, None]
    a_stream = torch.where(u, vref.write_raw32(av, a_cap), a_s)
    b_stream = torch.where(u, vref.write_raw32(b.masked_fill(~valid, 0), b_cap),
                           b_s)
    a_len = torch.where(use_raw, raw_len, a_total)
    b_len = torch.where(use_raw, raw_len, b_total)
    overflow = (a_len > a_cap) | (b_len > b_cap)
    return a_stream, a_len, b_stream, b_len, use_raw, overflow


def _decode_pairs(a_s, b_s, b_len, raw, count, m_out: int, universe: int,
                  sentinel: int):
    L, cap = a_s.shape
    count = count.to(_I32)
    idx = vref.arange(m_out, a_s)
    l = _ef_lowbits(universe, count)[:, None]

    # -- a: EF decode ------------------------------------------------------ #
    low = torch.zeros((L, m_out), dtype=_I32, device=a_s.device)
    for j in range(31):
        bit = _get_bit(a_s, idx * l + j) << j
        low |= bit.masked_fill_(~(j < l), 0)
    nbits = cap * 8
    bits = ((a_s[..., None].to(_I32) >> vref.arange(8, a_s)) & 1).view(L, nbits)
    lo_end = count[:, None] * l
    bidx = vref.arange(nbits, a_s)
    in_high = (bidx >= lo_end) & (bits > 0)
    del bits
    r = row_cumsum(in_high) - in_high.to(_I32)
    highs = vref.scatter_drop((L, m_out), r, in_high & (r < m_out),
                          bidx - lo_end - r, _I32)
    del in_high, r
    a_c = (highs << l) | low

    # -- b: varint + running sum restarted at each equal-a run ------------- #
    bv, _ = vref.parse_varints(b_s, b_len, m_out)
    prev_a = torch.cat([a_c.new_full((L, 1), -1), a_c[:, :-1]], dim=1)
    c0 = row_cumsum(bv)
    sidx = _last_true(a_c != prev_a)
    c_before = torch.gather(c0, 1, (sidx - 1).clamp_(0, m_out - 1).long())
    b_c = c0 - c_before.masked_fill_(sidx <= 0, 0)

    mask = idx < count[:, None]
    r = raw[:, None]
    a_out = torch.where(r, vref.read_raw32(a_s, m_out), a_c)
    b_out = torch.where(r, vref.read_raw32(b_s, m_out), b_c)
    return (a_out.masked_fill_(~mask, sentinel),
            b_out.masked_fill_(~mask, sentinel), mask)


def _pack_bools(bits, count, cap: int):
    L, m = bits.shape
    count = count.to(_I32)
    sel = bits & (vref.arange(m, bits) < count[:, None])
    nb = (m + 7) // 8
    pad = torch.zeros((L, nb * 8), dtype=_I32, device=bits.device)
    pad[:, :m] = sel
    packed = (pad.view(L, nb, 8) << vref.arange(8, bits)).sum(-1, dtype=_I32)
    stream = torch.zeros((L, cap), dtype=_U8, device=bits.device)
    w = min(nb, cap)
    stream[:, :w] = packed[:, :w]
    return stream, (count + 7) // 8


def _unpack_bools(stream, count, m_out: int):
    idx = vref.arange(m_out, stream)
    bit = _get_bit(stream, idx.expand(stream.shape[0], m_out))
    return (bit > 0) & (idx < count.to(_I32)[:, None])


# --------------------------------------------------------------------------- #
# One lane (the reference's per-lane API)
# --------------------------------------------------------------------------- #
def _one(outs: tuple) -> tuple:
    return tuple(x[0] for x in outs)


def encode_ids(ids: torch.Tensor, sentinel: int, cap: int):
    """One lane: sorted ids with sentinel holes -> compacted varint stream.

    Returns ``(stream (cap,) u8, length (), raw (), overflow ())``."""
    return _one(varint_ops.encode_ids(ids[None].contiguous(), sentinel,
                                      cap)[:4])


def decode_ids(stream, length, raw, m_out: int, sentinel: int):
    """Inverse of :func:`encode_ids`: ids land compacted at the front.

    Returns ``(ids (m_out,) ascending, sentinel-filled; mask (m_out,))``."""
    return _one(_decode_ids(stream[None], length.view(1), raw.view(1),
                            m_out, sentinel))


def scatter_compacted(rows_c: torch.Tensor, valid: torch.Tensor,
                      fill) -> torch.Tensor:
    """Spread compacted per-lane responses back onto the holed request
    slots: ``out[j] = rows_c[rank(j)]`` where ``valid[j]``, else ``fill``.
    ``rows_c``: (m, ...) compacted at the front; ``valid``: (m,)."""
    return vref.scatter_compacted_ref(rows_c[None], valid[None], fill)[0]


def encode_rows(rows: torch.Tensor, valid: torch.Tensor, sentinel: int,
                degs_cap: int, ids_cap: int):
    """One lane of adjacency windows ``rows (m, D)`` (sorted, sentinel
    padded; only ``valid`` rows coded, compacted to the front).

    Returns ``(degs_stream, degs_len, ids_stream, ids_len, raw, overflow)``.
    The raw escape stores the padded int32 rows in the id stream (degree
    stream empty)."""
    return _one(varint_ops.encode_rows(rows[None].contiguous(),
                                       valid[None].contiguous(), sentinel,
                                       degs_cap, ids_cap))


def decode_rows(degs_s, degs_len, ids_s, ids_len, raw, m: int, D: int,
                sentinel: int) -> torch.Tensor:
    """Inverse of :func:`encode_rows`: ``(m, D)`` windows, compacted at the
    front, sorted-then-sentinel exactly as ``DeviceGraph.rows_at`` emits."""
    return varint_ops.decode_rows(degs_s[None], degs_len.view(1),
                                  ids_s[None], ids_len.view(1), raw.view(1),
                                  m, D, sentinel)[0]


def encode_pairs(a: torch.Tensor, b: torch.Tensor, universe: int,
                 a_cap: int, b_cap: int):
    """One verifyE lane: pairs valid-at-the-front (fill = ``universe``),
    ``a`` non-decreasing, ``b`` ascending inside equal-``a`` runs.

    Returns ``(a_stream, a_len, b_stream, b_len, raw, overflow)``; the
    pair count is control-plane metadata (the exchange's ``counts``)."""
    return _one(_encode_pairs(a[None], b[None], universe, a_cap, b_cap))


def decode_pairs(a_s, a_len, b_s, b_len, raw, count, m_out: int,
                 universe: int, sentinel: int):
    """Inverse of :func:`encode_pairs`.  Returns ``(a, b, mask)`` with the
    pairs valid-at-the-front and ``sentinel`` fill.  ``a_len`` is unused:
    EF is sized by (universe, count), raw by count."""
    del a_len
    count = torch.as_tensor(count, device=a_s.device).view(1)
    return _one(_decode_pairs(a_s[None], b_s[None], b_len.view(1),
                              raw.view(1), count, m_out, universe, sentinel))


def pack_bools(bits: torch.Tensor, count, cap: int):
    """(m,) bools -> bit stream of the first ``count`` entries.
    Returns (stream (cap,) u8, length () = ceil(count/8))."""
    count = torch.as_tensor(count, device=bits.device).view(1)
    return _one(_pack_bools(bits[None], count, cap))


def unpack_bools(stream: torch.Tensor, count, m_out: int) -> torch.Tensor:
    """Inverse of :func:`pack_bools` (False past ``count``)."""
    count = torch.as_tensor(count, device=stream.device).view(1)
    return _unpack_bools(stream[None], count, m_out)[0]


# --------------------------------------------------------------------------- #
# Lane-grid wrappers (ndev, peer, ...) — what the engine stages call
# --------------------------------------------------------------------------- #
def _by_lane_groups(fn, lane_elems: int, *args) -> tuple:
    """``fn`` over lane-batched ``args`` (leading axis L), run on groups of
    lanes holding at most :data:`CODEC_CHUNK_ELEMS` payload elements and
    written into one set of outputs."""
    L = args[0].shape[0]
    step = max(1, CODEC_CHUNK_ELEMS // max(lane_elems, 1))
    if step >= L:
        return fn(*args)
    outs = None
    for i in range(0, L, step):
        part = fn(*(a[i:i + step] for a in args))
        if outs is None:
            outs = tuple(p.new_empty((L,) + p.shape[1:]) for p in part)
        for o, p in zip(outs, part):
            o[i:i + step] = p
        del part
    return outs


def _lanes(x: torch.Tensor, tail: int) -> torch.Tensor:
    """Flatten the lane grid: ``(ndev, peer, *t)`` -> ``(L, *t)``."""
    return x.reshape((-1,) + tuple(x.shape[x.dim() - tail:]))


def _fetch_lanes(fn, lane_elems: int, *args) -> tuple:
    """A fetch codec (:mod:`repro_torch.kernels.varint.ops`) over
    lane-batched ``args``: the kernels take every lane in one launch,
    the plain versions (CPU tensors) run in lane groups."""
    if args[0].device.type == "cpu":
        return _by_lane_groups(fn, lane_elems, *args)
    return fn(*args)


def encode_ids_lanes(wire: torch.Tensor, sentinel: int, cap: int):
    """``wire`` (ndev, peer, m): :func:`encode_ids` per lane.

    Also returns the per-lane *modeled* byte matrix (varints capped at
    4 B — ``engine._varint_id_bytes`` semantics) from the same sizing
    pass, so the fetch stage never sizes the lanes twice."""
    ndev, p, m = wire.shape
    s, ln, rw, ov, model = _fetch_lanes(
        lambda i: varint_ops.encode_ids(i, sentinel, cap), max(m, cap),
        _lanes(wire, 1).contiguous())
    return (s.view(ndev, p, cap), ln.view(ndev, p), rw.view(ndev, p),
            ov.any(), model.view(ndev, p))


def decode_ids_lanes(stream, length, raw, m_out: int, sentinel: int):
    lead = length.shape
    ids, mask = _by_lane_groups(
        lambda s, ln, r: _decode_ids(s, ln, r, m_out, sentinel),
        max(stream.shape[-1], m_out), _lanes(stream, 1), length.reshape(-1),
        raw.reshape(-1))
    return ids.view(lead + (m_out,)), mask.view(lead + (m_out,))


def encode_rows_lanes(rows, valid, sentinel: int, degs_cap: int,
                      ids_cap: int):
    lead = valid.shape[:-1]
    dg, dl, ids, il, rw, ov = _fetch_lanes(
        lambda r, v: varint_ops.encode_rows(r, v, sentinel, degs_cap,
                                            ids_cap),
        max(ids_cap, rows.shape[-2] * rows.shape[-1]),
        _lanes(rows, 2).contiguous(), _lanes(valid, 1).contiguous())
    return (dg.view(lead + (degs_cap,)), dl.view(lead),
            ids.view(lead + (ids_cap,)), il.view(lead), rw.view(lead),
            ov.any())


def decode_rows_lanes(degs_s, degs_len, ids_s, ids_len, raw, m: int,
                      D: int, sentinel: int, valid=None, out=None):
    """Inverse of :func:`encode_rows_lanes` over the lane grid ``lead =
    degs_len.shape``: ``lead + (m, D)`` windows compacted at the front;
    with ``valid (lead + (m,))`` spread onto the valid slots instead, as
    :func:`scatter_compacted_lanes` does; written into ``out`` when given.
    On the card the kernel reads the (transposed) streams and writes
    ``out`` in place; on the CPU the lanes run in groups."""
    if ids_s.device.type != "cpu":
        return varint_ops.decode_rows(degs_s, degs_len, ids_s, ids_len, raw,
                                      m, D, sentinel, valid=valid, out=out)
    lead = degs_len.shape
    args = [_lanes(degs_s, 1), degs_len.reshape(-1), _lanes(ids_s, 1),
            ids_len.reshape(-1), raw.reshape(-1)]
    if valid is not None:
        args.append(_lanes(valid, 1))
    rows = _by_lane_groups(
        lambda *a: (varint_ops.decode_rows(*a[:5], m, D, sentinel,
                                           valid=a[5] if valid is not None
                                           else None),),
        max(ids_s.shape[-1], m * D), *args)[0].view(lead + (m, D))
    return rows if out is None else out.copy_(rows)


def scatter_compacted_lanes(rows_c, valid, fill):
    lead = valid.shape[:-1]
    tail = rows_c.dim() - valid.dim() + 1
    out = vref.scatter_compacted_ref(_lanes(rows_c, tail), _lanes(valid, 1),
                                     fill)
    return out.view(lead + out.shape[1:])


def encode_pairs_lanes(a, b, universe: int, a_cap: int, b_cap: int):
    lead = a.shape[:-1]
    a_s, al, b_s, bl, rw, ov = _by_lane_groups(
        lambda x, y: _encode_pairs(x, y, universe, a_cap, b_cap),
        max(8 * a_cap, b_cap), _lanes(a, 1), _lanes(b, 1))
    return (a_s.view(lead + (a_cap,)), al.view(lead),
            b_s.view(lead + (b_cap,)), bl.view(lead), rw.view(lead),
            ov.any())


def decode_pairs_lanes(a_s, a_len, b_s, b_len, raw, count, m_out: int,
                       universe: int, sentinel: int):
    del a_len
    lead = count.shape
    a, b, mask = _by_lane_groups(
        lambda s1, s2, l2, r, c: _decode_pairs(s1, s2, l2, r, c, m_out,
                                               universe, sentinel),
        max(8 * a_s.shape[-1], b_s.shape[-1], m_out), _lanes(a_s, 1),
        _lanes(b_s, 1), b_len.reshape(-1), raw.reshape(-1),
        count.reshape(-1))
    shape = lead + (m_out,)
    return a.view(shape), b.view(shape), mask.view(shape)


def pack_bools_lanes(bits, count, cap: int):
    lead = count.shape
    s, ln = _pack_bools(_lanes(bits, 1), count.reshape(-1), cap)
    return s.view(lead + (cap,)), ln.view(lead)


def unpack_bools_lanes(stream, count, m_out: int):
    lead = count.shape
    return _unpack_bools(_lanes(stream, 1), count.reshape(-1),
                         m_out).view(lead + (m_out,))


# --------------------------------------------------------------------------- #
# Measured wire-format auto-selection (EngineConfig.wire_format="auto")
# --------------------------------------------------------------------------- #
def resolve_wire_format(requested: str, mode: str, prior: dict | None = None,
                        hysteresis: float = 0.05) -> tuple[str, str]:
    """Resolve ``wire_format="auto"`` to a concrete codec for this run.

    The driver persists one *trial* per ``(exchange mode, format)`` into
    the priors entry (``wire_trials[f"{mode}:{fmt}"] = {"pipeline_s": ...,
    "wire_bytes": ...}``, compile time already subtracted) — the measured
    bytes-vs-wall tradeoff the CPU sim needs to stop paying 3x wall for
    compression whose bytes are free intra-process.  Resolution:

    * both formats measured -> the lower ``pipeline_s`` wins, with
      ``hysteresis`` sticking to the previously recorded choice unless the
      challenger is more than that fraction faster (a stable choice keeps
      warm runs on already-persisted executables — flapping would re-trace
      fetch/verify every run);
    * one format measured -> *explore* the other (deterministic, so two
      runs complete the table);
    * nothing measured -> heuristic: transports whose bytes cost real
      time (``spmd`` collectives, ``dist`` across process boundaries)
      default to ``varint``, the intra-process reference backends to
      ``raw`` (their bytes are free, codec compute is not).

    Returns ``(format, reason)`` with reason in ``{"explicit", "measured",
    "explore", "heuristic"}`` — the driver reports it as
    ``stats["wire_auto_reason"]``.

    The function itself is pure: the same priors give the same answer in
    both packages.  But the "measured" branch compares recorded wall
    times, so two runs of either package (or one of each) on the same
    input may pick different codecs, as ``pipeline_depth="auto"`` may
    pick different depths (:mod:`repro_torch.core.scheduler`).  Counts
    and embeddings never differ between them; the wire bytes
    (``bytes_wire_*``, their per-device arrays, ``comm_skew``) do."""
    if requested != "auto":
        return requested, "explicit"
    trials = (prior or {}).get("wire_trials", {})
    t = {f: trials.get(f"{mode}:{f}") for f in ("raw", "varint")}
    have = [f for f in ("raw", "varint") if t[f]]
    if len(have) == 2:
        best = min(("raw", "varint"), key=lambda f: t[f]["pipeline_s"])
        prev = (prior or {}).get("wire_choice", {}).get(mode)
        if prev in ("raw", "varint") and best != prev \
                and t[best]["pipeline_s"] >= (1.0 - hysteresis) \
                * t[prev]["pipeline_s"]:
            best = prev
        return best, "measured"
    if len(have) == 1:
        return ("varint" if have[0] == "raw" else "raw"), "explore"
    return ("varint" if mode in ("spmd", "dist") else "raw"), "heuristic"


def register_wire_metrics(reg, chosen: str, requested: str,
                          reason: str) -> None:
    """Set the wire-codec instruments on a stats registry (declared in
    :mod:`repro_torch.obs.schema`): the format actually on the wire
    (``wire_format``), what the config asked for
    (``wire_format_requested``), why auto-selection picked it
    (``wire_auto_reason``), and the modeled compressed-fetch baseline
    accumulator (``bytes_fetch_compressed``) the per-wave stats add into."""
    reg["wire_format"] = chosen
    reg["wire_format_requested"] = requested
    reg["wire_auto_reason"] = reason
    reg["bytes_fetch_compressed"] = 0.0
