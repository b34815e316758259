"""Varint fetch codec entry points: the CUDA kernels on the card, the
plain PyTorch versions on the CPU.

* :func:`encode_ids` ("encode_ids") — request id lanes -> id streams,
  with lengths, raw and overflow flags and the modeled byte counts;
* :func:`delta_vlen` ("delta_vlen") — the sizing pass alone (the
  epilogue of the same kernel): deltas and their LEB128 sizes;
* :func:`encode_rows` ("encode_rows") — lanes of adjacency windows ->
  degree and id streams, reading only the valid rows;
* :func:`decode_rows` ("decode_rows") — the inverse, parsing only the
  live bytes, optionally onto the requester's slots.

The tensor's device decides.  A CUDA tensor launches the kernel or
raises — there is no fallback — and each launch (one call of a variant's
C entry point, which enqueues that variant's passes) adds one to
:data:`launches` and to its variant's count in
:data:`launches_by_variant`, so a run can show that its main path went
through the kernels.  A CPU tensor runs the plain version
(:mod:`repro_torch.kernels.varint.ref`).  The kernels take every lane of
a call in one launch.
"""
from __future__ import annotations

import torch

# module objects, not names: core.wire imports this module while the
# plain versions' own import of core.exchange may still be running
from repro_torch.kernels.varint import ref

launches = 0    # kernel launches since the count was last set to 0
VARIANTS = ("delta_vlen", "encode_ids", "encode_rows", "decode_rows")
launches_by_variant = dict.fromkeys(VARIANTS, 0)   # the same, by variant


def _count(variant: str) -> None:
    global launches
    launches += 1
    launches_by_variant[variant] += 1


def _check(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    if t.dim() != ndim:
        raise ValueError(f"{name} wants {ndim} dims, got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} wants {dtypes}, got {t.dtype}")


def _on_cuda(*ts: torch.Tensor) -> bool:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"tensors on {[str(t.device) for t in ts]}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the varint codec runs on cuda or cpu, not {dev}")
    return dev.type == "cuda"


def delta_vlen(ids: torch.Tensor, sentinel: int):
    """ids (B, M) int32, ascending among the valid (< sentinel) entries ->
    ``(delta (B, M) int32, vlen (B, M) int32)`` (see
    :func:`~repro_torch.kernels.varint.ref.delta_vlen_ref`)."""
    _check("delta_vlen ids", ids, (torch.int32,), 2)
    if not ids.is_contiguous():
        raise ValueError("delta_vlen wants a contiguous tensor")
    if not _on_cuda(ids):
        return ref.delta_vlen_ref(ids, sentinel)
    from repro_torch.kernels.varint import kernel

    delta = torch.empty_like(ids)
    vlen = torch.empty_like(ids)
    if ids.numel():
        kernel.encode_ids_cuda(ids, int(sentinel), 0, delta=delta, vlen=vlen)
        _count("delta_vlen")
    return delta, vlen


def encode_ids(ids: torch.Tensor, sentinel: int, cap: int):
    """Request id lanes ``ids (L, M)`` int32 (ascending among the valid
    entries, sentinel holes) -> ``(stream (L, cap) u8, length (L,) int32,
    raw (L,) bool, overflow (L,) bool, model (L,) int32)`` (see
    :func:`~repro_torch.kernels.varint.ref.encode_ids_ref`)."""
    _check("encode_ids ids", ids, (torch.int32,), 2)
    if not ids.is_contiguous():
        raise ValueError("encode_ids wants a contiguous tensor")
    if not _on_cuda(ids):
        return ref.encode_ids_ref(ids, sentinel, cap)
    from repro_torch.kernels.varint import kernel

    L = ids.shape[0]
    dev = ids.device
    outs = (torch.empty((L, cap), dtype=torch.uint8, device=dev),
            torch.empty(L, dtype=torch.int32, device=dev),
            torch.empty(L, dtype=torch.bool, device=dev),
            torch.empty(L, dtype=torch.bool, device=dev),
            torch.empty(L, dtype=torch.int32, device=dev))
    if L:
        kernel.encode_ids_cuda(ids, int(sentinel), int(cap), outs=outs)
        _count("encode_ids")
    return outs


def encode_rows(rows: torch.Tensor, valid: torch.Tensor, sentinel: int,
                degs_cap: int, ids_cap: int):
    """Lanes of adjacency windows ``rows (L, m, D)`` int32 with ``valid
    (L, m)`` -> ``(degs_stream (L, degs_cap) u8, degs_len (L,) int32,
    ids_stream (L, ids_cap) u8, ids_len (L,) int32, raw (L,) bool,
    overflow (L,) bool)`` (see
    :func:`~repro_torch.kernels.varint.ref.encode_rows_ref`)."""
    _check("encode_rows rows", rows, (torch.int32,), 3)
    _check("encode_rows valid", valid, (torch.bool,), 2)
    if valid.shape != rows.shape[:2]:
        raise ValueError(f"valid {tuple(valid.shape)} does not match rows "
                         f"{tuple(rows.shape)}")
    if not (rows.is_contiguous() and valid.is_contiguous()):
        raise ValueError("encode_rows wants contiguous tensors")
    if not _on_cuda(rows, valid):
        return ref.encode_rows_ref(rows, valid, sentinel, degs_cap, ids_cap)
    from repro_torch.kernels.varint import kernel

    L = rows.shape[0]
    dev = rows.device
    outs = (torch.empty((L, degs_cap), dtype=torch.uint8, device=dev),
            torch.empty(L, dtype=torch.int32, device=dev),
            torch.empty((L, ids_cap), dtype=torch.uint8, device=dev),
            torch.empty(L, dtype=torch.int32, device=dev),
            torch.empty(L, dtype=torch.bool, device=dev),
            torch.empty(L, dtype=torch.bool, device=dev))
    if L:
        kernel.encode_rows_cuda(rows, valid, int(sentinel), outs)
        _count("encode_rows")
    return outs


def decode_rows(degs_s, degs_len, ids_s, ids_len, raw, m: int, D: int,
                sentinel: int, valid: torch.Tensor | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse of :func:`encode_rows`: ``lead + (m, D)`` int32 windows,
    compacted at the front, or with ``valid (lead + (m,))`` the r-th
    decoded row on the r-th valid slot and the sentinel elsewhere (see
    :func:`~repro_torch.kernels.varint.ref.decode_rows_ref`).

    ``lead`` is one lane axis ``(L,)`` or a lane grid ``(T, S)``.  On the
    card the streams and ``out`` may be strided views over the lane
    grid (an exchange's transpose, a slice of a larger buffer), as long
    as each lane's own bytes or rows are contiguous; the kernel writes
    ``out`` (allocated when not given) in place."""
    lead = tuple(degs_len.shape)
    if len(lead) not in (1, 2):
        raise ValueError(f"decode_rows wants one or two lane axes, got "
                         f"{lead}")
    for name, t, dt, tail in (("degs_s", degs_s, torch.uint8, 1),
                              ("ids_s", ids_s, torch.uint8, 1),
                              ("degs_len", degs_len, torch.int32, 0),
                              ("ids_len", ids_len, torch.int32, 0),
                              ("raw", raw, torch.bool, 0)):
        _check(f"decode_rows {name}", t, (dt,), len(lead) + tail)
        if tuple(t.shape[:len(lead)]) != lead:
            raise ValueError(f"decode_rows {name} {tuple(t.shape)} does not "
                             f"match the lanes {lead}")
    if valid is not None:
        _check("decode_rows valid", valid, (torch.bool,), len(lead) + 1)
        if tuple(valid.shape) != lead + (m,):
            raise ValueError(f"valid {tuple(valid.shape)} != {lead + (m,)}")
    if out is not None and (tuple(out.shape) != lead + (m, D)
                            or out.dtype != torch.int32):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} != "
                         f"{lead + (m, D)} int32")
    extra = [t for t in (valid, out) if t is not None]
    if not _on_cuda(degs_s, degs_len, ids_s, ids_len, raw, *extra):
        rows = ref.decode_rows_ref(
            degs_s.reshape(-1, degs_s.shape[-1]), degs_len.reshape(-1),
            ids_s.reshape(-1, ids_s.shape[-1]), ids_len.reshape(-1),
            raw.reshape(-1), m, D, sentinel,
            None if valid is None else valid.reshape(-1, m)).view(
                lead + (m, D))
        if out is None:
            return rows
        return out.copy_(rows)
    from repro_torch.kernels.varint import kernel

    if out is None:
        out = torch.empty(lead + (m, D), dtype=torch.int32,
                          device=ids_s.device)
    if out.numel():
        kernel.decode_rows_cuda(degs_s, degs_len, ids_s, ids_len, raw, m, D,
                                int(sentinel), valid, out)
        _count("decode_rows")
    return out
