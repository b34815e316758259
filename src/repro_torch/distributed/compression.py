"""Gradient compression: int8 quantization with error feedback (EF-SGD
style), as the reference's ``distributed/compression.py``.

``compress_roundtrip(g, err)`` quantizes and dequantizes each gradient
with its error-feedback state; the trainer applies it every step under
``grad_compression="int8_ef"``.  ``compressed_psum(x, axis, mesh)`` is
the quantized all-reduce over one mesh axis (the 'pod' axis of the
multi-pod mesh) over ``torch.distributed``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _quant(x: torch.Tensor):
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compress_roundtrip(g: dict, err: dict):
    """Per tensor int8 quantize -> dequantize with error feedback:
    ``(g_hat, new_err)``, dicts keyed as ``g``; ``err`` holds float32
    tensors shaped as ``g``'s, and ``g_hat`` keeps each gradient's
    dtype."""
    g_hat, new_err = {}, {}
    for k, gl in g.items():
        gl32 = gl.float() + err[k]
        q, s = _quant(gl32)
        gh = _dequant(q, s)
        g_hat[k], new_err[k] = gh.to(gl.dtype), gl32 - gh
    return g_hat, new_err


def init_error_feedback(params: dict) -> dict:
    """Zero float32 error-feedback state beside each parameter."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


@torch.no_grad()
def compressed_psum(x: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``mesh``'s ``axis``, quantized
    as the reference's ``compressed_psum``: ``x`` is this rank's row (the
    reference stacks the rows on ``axis`` and shards them over it).  One
    ``all_reduce(MAX)`` agrees on a global scale, ``max(|x|) / 127`` in
    float32 (floored at 1e-12 / 127); each element is rounded to an
    integer in [-127, 127]; one ``all_reduce(SUM)`` adds the integers;
    the sum times the scale is returned in ``x``'s dtype, the same on
    every rank of the axis.  The integers travel as int32, 4 bytes an
    element, as the reference's ``psum`` of int32 does."""
    group = mesh.get_group(axis)
    x32 = x.float()
    gmax = x32.abs().amax().reshape(1)
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(gmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return (q.float() * scale).to(x.dtype)
