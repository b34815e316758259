"""Plain PyTorch version of the delta+varint sizing pass (the CPU path,
and what the CUDA kernel is held against on the card).

``delta_vlen_ref(ids, sentinel)``: ids (B, M) sorted ascending among the
valid (< sentinel) entries, sentinel holes allowed.  Returns

* ``delta`` (B, M) int32 — each valid id minus the previous valid id in its
  row (the first valid id absolute); 0 at holes,
* ``vlen``  (B, M) int32 — LEB128 byte length of that delta (1..5); 0 at
  holes.

This is the sizing half of the fetchV id wire codec
(:mod:`repro_torch.core.wire`); the byte scatter stays PyTorch on both
paths.
"""
from __future__ import annotations

import torch


def varint_size(v: torch.Tensor) -> torch.Tensor:
    """LEB128 byte length of non-negative int32 values (1..5) as int32 —
    the one sizing ladder every codec path shares (the CUDA kernel inlines
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
