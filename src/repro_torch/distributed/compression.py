"""Gradient compression: int8 quantization with error feedback (EF-SGD
style), as the reference's ``distributed/compression.py``.

``compress_roundtrip(g, err)`` quantizes and dequantizes each gradient
with its error-feedback state; the trainer applies it every step under
``grad_compression="int8_ef"``.  The reference's ``compressed_psum``
(an int8-payload all-reduce over a mesh axis) comes with the mesh slice
(ROADMAP.md queue A item 16).
"""
from __future__ import annotations

import torch


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
