"""ctypes bindings of the varint fetch codec's CUDA kernels:
``csrc/varint_encode.cu`` ("ids", with delta_vlen as its sizing-only
epilogue, and "rows") and ``csrc/varint_decode.cu`` ("rows").

The TPU kernel they replace is ``delta_vlen_pallas``
(``src/repro/kernels/varint/kernel.py``), with the codec around it; the
sources' headers say what bounds them on the H100 and what their design
does about that.  The libraries are built at first use
(:mod:`repro_torch.kernels.build`).  Each launcher enqueues its passes on
the current stream of the tensors' device; the caller has checked
shapes, dtypes, devices and contiguity.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build

CSRC = Path(__file__).resolve().parent / "csrc"
ENCODE_SOURCE = CSRC / "varint_encode.cu"
DECODE_SOURCE = CSRC / "varint_decode.cu"
SOURCES = (ENCODE_SOURCE, DECODE_SOURCE)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    "varint_encode_ids_scratch": (ENCODE_SOURCE, [_LL, _LL], _LL),
    "varint_encode_ids_launch": (ENCODE_SOURCE, [
        _P, _LL, _LL, _I, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _P], _I),
    "varint_encode_rows_scratch": (ENCODE_SOURCE, [_LL, _LL], _LL),
    "varint_encode_rows_launch": (ENCODE_SOURCE, [
        _P, _P, _LL, _LL, _LL, _I, _LL, _LL, _P, _P, _P, _P, _P, _P, _P, _P],
        _I),
    "varint_decode_rows_scratch": (DECODE_SOURCE, [_LL, _LL, _LL], _LL),
    "varint_decode_rows_launch": (DECODE_SOURCE, [
        _P, _LL, _LL, _LL, _P, _P, _LL, _LL, _LL, _P, _P, _P, _LL, _LL, _LL,
        _LL, _I, _P, _LL, _LL, _P, _P], _I),
}


def _fn(name: str):
    source, argtypes, restype = _SIGNATURES[name]
    fn = getattr(build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _scratch(nbytes: int, device) -> torch.Tensor:
    return torch.empty(max(int(nbytes), 1), dtype=torch.uint8, device=device)


def _launch(name: str, device, *args) -> None:
    with torch.cuda.device(device):
        err = _fn(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def encode_ids_cuda(ids: torch.Tensor, sentinel: int, cap: int,
                    outs: tuple | None = None,
                    delta: torch.Tensor | None = None,
                    vlen: torch.Tensor | None = None) -> None:
    """``outs`` = (stream, length, raw, overflow, model) for the "ids"
    variant; or ``delta`` and ``vlen`` for the sizing pass alone."""
    L, M = ids.shape
    scratch = _scratch(_fn("varint_encode_ids_scratch")(L, M), ids.device)
    stream, length, raw, overflow, model = outs or (None,) * 5
    _launch("varint_encode_ids_launch", ids.device, ids.data_ptr(), L, M,
            sentinel, cap, _ptr(delta), _ptr(vlen), _ptr(stream),
            _ptr(length), _ptr(raw), _ptr(overflow), _ptr(model),
            scratch.data_ptr())


def encode_rows_cuda(rows: torch.Tensor, valid: torch.Tensor, sentinel: int,
                     outs: tuple) -> None:
    """``outs`` = (degs_s, degs_len, ids_s, ids_len, raw, overflow)."""
    L, m, D = rows.shape
    degs_s, degs_len, ids_s, ids_len, raw, overflow = outs
    scratch = _scratch(_fn("varint_encode_rows_scratch")(L, m), rows.device)
    _launch("varint_encode_rows_launch", rows.device, rows.data_ptr(),
            valid.data_ptr(), L, m, D, sentinel, degs_s.shape[1],
            ids_s.shape[1], degs_s.data_ptr(), degs_len.data_ptr(),
            ids_s.data_ptr(), ids_len.data_ptr(), raw.data_ptr(),
            overflow.data_ptr(), scratch.data_ptr())


def _grid_strides(t: torch.Tensor, lead: int, tail: int) -> tuple[int, int]:
    """The (T, S) lane strides of ``t`` (elements), whose ``tail`` trailing
    dims must be contiguous; one lane axis reads as T = 1."""
    want = 1
    for d in range(t.dim() - 1, t.dim() - 1 - tail, -1):
        if t.shape[d] > 1 and t.stride(d) != want:
            raise ValueError(f"decode_rows wants each lane contiguous, got "
                             f"strides {t.stride()} for {tuple(t.shape)}")
        want *= t.shape[d]
    if lead == 1:
        return 0, t.stride(0)
    return t.stride(0), t.stride(1)


def decode_rows_cuda(degs_s, degs_len, ids_s, ids_len, raw, m: int, D: int,
                     sentinel: int, valid, out) -> None:
    lead = degs_len.dim()
    T, S = (1, degs_len.shape[0]) if lead == 1 else tuple(degs_len.shape)
    small = [x.contiguous() for x in (degs_len, ids_len, raw)]
    if valid is not None:
        valid = valid.contiguous()
    L = T * S
    dcap, icap = degs_s.shape[-1], ids_s.shape[-1]
    scratch = _scratch(_fn("varint_decode_rows_scratch")(L, m, icap),
                       ids_s.device)
    _launch("varint_decode_rows_launch", ids_s.device, degs_s.data_ptr(),
            *_grid_strides(degs_s, lead, 1), dcap, small[0].data_ptr(),
            ids_s.data_ptr(), *_grid_strides(ids_s, lead, 1), icap,
            small[1].data_ptr(), small[2].data_ptr(), _ptr(valid), T, S, m,
            D, sentinel, out.data_ptr(), *_grid_strides(out, lead, 2),
            scratch.data_ptr())
