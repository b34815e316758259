"""Plain PyTorch versions of the varint fetch codec's kernels (the CPU
path, and what the CUDA kernels are held against on the card).

* :func:`delta_vlen_ref` — the sizing pass of the request id encoder:
  ids (B, M) sorted ascending among the valid (< sentinel) entries,
  sentinel holes allowed ->

  * ``delta`` (B, M) int32 — each valid id minus the running maximum of
    the valid ids before it in its row (the first valid id absolute),
    clamped at 0; 0 at holes,
  * ``vlen``  (B, M) int32 — LEB128 byte length of that delta (1..5); 0
    at holes.

* :func:`encode_ids_ref` — one request id stream per lane (the deltas
  LEB128-coded, or the valid ids compacted as raw int32), with its
  length, raw and overflow flags and the modeled byte count;
* :func:`encode_rows_ref` — one lane of adjacency windows into a degree
  stream and an id stream (per valid row: the first id absolute, then
  consecutive differences), or the valid rows compacted as raw int32;
* :func:`decode_rows_ref` — the inverse, optionally spread straight onto
  the requester's slots (:func:`scatter_compacted_ref`).

Every stream, length and flag equals the reference's
(``src/repro/core/wire.py``) byte for byte; :mod:`repro_torch.core.wire`
describes the stream layout.  The byte-level helpers here are shared with
the codecs that stay plain PyTorch on both paths (the request id decoder
and the verifyE pair codec).  The reference's ``.at[...].set/add(
mode="drop")`` scatters become ``scatter_`` into a buffer with one
private dump slot per source element past the ``cap`` real ones (so
dropped writes never contend for one address), cut back to ``cap``.
Running sums along a lane go through one flat scan (:func:`row_cumsum`)
and keep the reference's int32 wrap-around.  The LEB128 parse finds each
byte's position inside its value from the (at most four) continuation
bytes before it.  The raw escape writes and reads whole int32 words
through a ``uint8``<->``int32`` view (both the CPU and the card are
little-endian).
"""
from __future__ import annotations

import torch

from repro_torch.core.exchange import compact, masked, row_cumsum

_U8 = torch.uint8
_I32 = torch.int32


def varint_size(v: torch.Tensor) -> torch.Tensor:
    """LEB128 byte length of non-negative int32 values (1..5) as int32 —
    the one sizing ladder every codec path shares (the CUDA kernels inline
    the same compares)."""
    v = v.to(torch.int32)
    out = (v >= 1 << 7).to(torch.int32)
    for k in (14, 21, 28):
        out += v >= 1 << k
    return out.add_(1)


def delta_vlen_ref(ids: torch.Tensor, sentinel: int):
    valid = ids < sentinel
    run = torch.cummax(ids.masked_fill(~valid, -1), dim=-1).values
    prev = torch.cat([torch.full_like(run[..., :1], -1), run[..., :-1]],
                     dim=-1)
    delta = torch.where(prev >= 0, ids - prev, ids)
    delta = delta.clamp_(min=0).masked_fill_(~valid, 0)
    vlen = varint_size(delta).masked_fill_(~valid, 0)
    return delta, vlen


# --------------------------------------------------------------------------- #
# Byte-level helpers over a batch of lanes (L, ...)
# --------------------------------------------------------------------------- #
def arange(k: int, like: torch.Tensor, dtype=_I32) -> torch.Tensor:
    return torch.arange(k, dtype=dtype, device=like.device)


def drop_index(idx: torch.Tensor, keep: torch.Tensor,
               cap: int) -> torch.Tensor:
    """``idx (L, K)`` where ``keep``, else a private dump slot per source
    element past ``cap``, as int64 for ``scatter_``; the caller's buffer
    holds ``cap + K`` slots and is cut back to ``cap``."""
    dump = cap + torch.arange(idx.shape[1], device=idx.device)
    return torch.where(keep, idx.long(), dump)


def scatter_drop(buf_shape: tuple, idx: torch.Tensor, keep: torch.Tensor,
                 src: torch.Tensor, dtype, add: bool = False
                 ) -> torch.Tensor:
    """``out[l, idx[l, k]] = src[l, k]`` (or ``+=``) where ``keep``, into a
    zeroed ``(L, cap)`` buffer; dropped writes are cut off."""
    L, cap = buf_shape
    index = drop_index(idx, keep, cap)
    buf = torch.zeros((L, cap + idx.shape[1]), dtype=dtype, device=idx.device)
    if add:
        buf.scatter_add_(1, index, src.to(dtype))
    else:
        buf.scatter_(1, index, src.to(dtype))
    return buf[:, :cap]


def write_varints(vals: torch.Tensor, vlen: torch.Tensor, cap: int):
    """LEB128 codes of ``vals (L, K)`` (non-negative) with byte sizes
    ``vlen (L, K)`` (0 = skip), laid out in order at the exclusive running
    sum of ``vlen``; bytes past ``cap`` are dropped.  Returns ``(stream
    (L, cap) u8, total (L,) int32)``."""
    L, K = vals.shape
    vals = vals.to(_I32)
    vlen = vlen.to(_I32)
    offs = row_cumsum(vlen) - vlen
    total = vlen.sum(-1, dtype=_I32)
    buf = torch.zeros((L, cap + K), dtype=_U8, device=vals.device)
    for b in range(5):
        pos = offs + b
        index = drop_index(pos, (vlen > b) & (pos < cap), cap)
        byte = (vals >> (7 * b)) & 0x7F
        byte |= (vlen > b + 1).to(_I32) << 7
        buf.scatter_(1, index, byte.to(_U8))
        del pos, index, byte
    return buf[:, :cap], total


def _shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """``out[:, i] = x[:, i - k]``, False for ``i < k``."""
    L, n = x.shape
    k = min(k, n)
    return torch.cat([x.new_zeros((L, k)), x[:, :n - k]], dim=1)


def parse_varints(stream: torch.Tensor, length: torch.Tensor, m_out: int):
    """Inverse of :func:`write_varints`: ``(vals (L, m_out) int32, count
    (L,) int32)``.

    A clear high bit ends a value.  A byte's value index is the number of
    terminators before it; its place inside the value is the number of
    continuation bytes right before it, at most 4 (the reference's
    ``clip(idx - last_value_start, 0, 4)``).  One scatter-add assembles
    the 7-bit payloads."""
    L, cap = stream.shape
    inb = arange(cap, stream) < length.view(L, 1)
    cont = stream >= 0x80
    term = inb & ~cont
    place = torch.zeros((L, cap), dtype=_I32, device=stream.device)
    run = torch.ones_like(cont)
    for k in range(1, 5):
        run &= _shift_right(cont, k)
        place += run
    del run, cont
    contrib = (stream & 0x7F).to(_I32) << (7 * place)
    del place
    seg = row_cumsum(term) - term.to(_I32)
    keep = inb & (seg < m_out)
    vals = scatter_drop((L, m_out), seg, keep,
                        contrib.masked_fill_(~inb, 0), _I32, add=True)
    return vals, term.sum(-1, dtype=_I32)


def write_raw32(words: torch.Tensor, cap: int) -> torch.Tensor:
    """Little-endian int32 ``words (L, W)`` as a ``cap``-byte stream (the
    raw escape): cut at ``cap``, zero-padded beyond ``4 W``."""
    L, W = words.shape
    data = words.to(_I32).contiguous().view(_U8)
    if 4 * W >= cap:
        return data[:, :cap].contiguous()
    out = torch.zeros((L, cap), dtype=_U8, device=words.device)
    out[:, :4 * W] = data
    return out


def read_raw32(stream: torch.Tensor, k: int) -> torch.Tensor:
    """The first ``k`` little-endian int32 words of each lane.  A word that
    reaches past the stream reads ``stream[min(4 j + b, cap - 1)]`` for its
    byte ``b``, as the reference's clipped gather does."""
    L, cap = stream.shape
    full = min(k, cap // 4)
    s = stream[:, :4 * full]
    if cap % 4:
        s = s.contiguous()
    words = s.view(_I32)
    if k == full:
        return words
    j = arange(k - full, stream, torch.int64) + full
    pos = (4 * j[:, None] + torch.arange(4, device=stream.device)).clamp_(
        max=cap - 1)
    b = stream[:, pos].to(_I32)                       # (L, k - full, 4)
    tail = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    return torch.cat([words, tail], dim=1)


# --------------------------------------------------------------------------- #
# The fetch codec's lane functions (leading lane axis L)
# --------------------------------------------------------------------------- #
def encode_ids_ref(ids: torch.Tensor, sentinel: int, cap: int):
    """ids (L, M) -> ``(stream (L, cap) u8, length (L,) int32, raw (L,)
    bool, overflow (L,) bool, model (L,) int32)``; ``model`` sums the
    varint sizes capped at 4 B (``engine._varint_id_bytes`` semantics)."""
    delta, vlen = delta_vlen_ref(ids, sentinel)
    valid = vlen > 0
    count = valid.sum(-1, dtype=_I32)
    coded, total = write_varints(delta, vlen, cap)
    raw_len = 4 * count
    use_raw = (total > raw_len) | (total > cap)
    packed = compact(valid, ids.shape[1], ids, fill=0)[2]
    stream = torch.where(use_raw[:, None], write_raw32(packed, cap), coded)
    length = torch.where(use_raw, raw_len, total)
    model = vlen.clamp(max=4).sum(-1, dtype=_I32)
    return stream, length, use_raw, length > cap, model


def encode_rows_ref(rows: torch.Tensor, valid: torch.Tensor, sentinel: int,
                    degs_cap: int, ids_cap: int):
    """rows (L, m, D), valid (L, m) -> ``(degs_stream, degs_len,
    ids_stream, ids_len, raw, overflow)``, the flags per lane."""
    L, m, D = rows.shape
    deg = (rows < sentinel).sum(-1, dtype=_I32).masked_fill_(~valid, 0)
    dvl = varint_size(deg).masked_fill_(~valid, 0)
    degs_s, degs_total = write_varints(deg, dvl, degs_cap)

    ok = valid[..., None] & (arange(D, rows) < deg[..., None])
    dmat = rows.clone()
    dmat[..., 1:] -= rows[..., :-1]
    dmat = dmat.clamp_(min=0).masked_fill_(~ok, 0)
    vl = varint_size(dmat).masked_fill_(~ok, 0)
    del ok
    ids_s, ids_total = write_varints(dmat.view(L, -1), vl.view(L, -1),
                                     ids_cap)
    del dmat, vl

    count = valid.sum(-1, dtype=_I32)
    raw_len = 4 * D * count
    use_raw = ((degs_total + ids_total > raw_len) | (ids_total > ids_cap)
               | (degs_total > degs_cap))
    packed = compact(valid, m, rows, fill=0)[2]
    raw_s = write_raw32(packed.view(L, -1), ids_cap)
    del packed
    ids_stream = torch.where(use_raw[:, None], raw_s, ids_s)
    degs_stream = degs_s.masked_fill(use_raw[:, None], 0)
    ids_len = torch.where(use_raw, raw_len, ids_total)
    degs_len = degs_total.masked_fill(use_raw, 0)
    overflow = (ids_len > ids_cap) | (degs_len > degs_cap)
    return degs_stream, degs_len, ids_stream, ids_len, use_raw, overflow


def scatter_compacted_ref(rows_c: torch.Tensor, valid: torch.Tensor, fill):
    """``out[l, j] = rows_c[l, rank(j)]`` where ``valid[l, j]``, else
    ``fill``; ``rank(j)`` counts the valid slots before ``j``."""
    L, m = valid.shape
    rank = (row_cumsum(valid) - 1).clamp_(0, m - 1)
    lane = torch.arange(L, device=valid.device)[:, None]
    return masked(rows_c[lane, rank], valid, fill)


def decode_rows_ref(degs_s, degs_len, ids_s, ids_len, raw, m: int, D: int,
                    sentinel: int, valid: torch.Tensor | None = None):
    """Inverse of :func:`encode_rows_ref`: ``(L, m, D)`` windows compacted
    at the front; with ``valid (L, m)`` the r-th decoded row lands on the
    r-th valid slot instead (:func:`scatter_compacted_ref`)."""
    L = degs_s.shape[0]
    degs, count_c = parse_varints(degs_s, degs_len, m)
    rstart = row_cumsum(degs) - degs
    flat, _ = parse_varints(ids_s, ids_len, m * D)
    col = arange(D, degs)
    f = (rstart[..., None] + col).clamp_(0, m * D - 1)
    dmat = torch.gather(flat, 1, f.view(L, -1).long()).view(L, m, D)
    del flat, f
    row = arange(m, degs)
    ok = (col < degs[..., None]) & (row[:, None] < count_c.view(L, 1, 1))
    rows_c = torch.cumsum(dmat.masked_fill_(~ok, 0), dim=-1, dtype=_I32)
    rows_c.masked_fill_(~ok, sentinel)
    del dmat, ok
    count_r = ids_len // (4 * D)
    rows_r = read_raw32(ids_s, m * D).view(L, m, D)
    rows_r = masked(rows_r, row < count_r[:, None], sentinel)
    rows = torch.where(raw.view(L, 1, 1), rows_r, rows_c)
    if valid is None:
        return rows
    return scatter_compacted_ref(rows, valid, sentinel)
