"""flash-attention entry point in the model's (B, S, H, D) layout: the
CUDA kernel on the card, the plain PyTorch version on the CPU.

The tensor's device decides.  A CUDA tensor launches the kernel or
raises — there is no fallback — and each launch adds one to
:data:`launches`, so a run can show that its main path went through the
kernel.  Which of the kernel's variants runs is decided before the
launch by :func:`route`, from dtype, head width and alignment alone, and
counted in :data:`launches_by_variant`: "wgmma" (bf16 on the tensor
cores, TMA-fed) or "simt" (f32 on the CUDA cores, and every other
shape).  The kernel reads the (B, S, H, D) tensors in place and indexes
the kv head of query head ``h`` as ``h // (H // Hk)``.  A CPU tensor
takes the reference's ``ops.py`` route: GQA broadcast by ``repeat``, the
(B·H, S, D) layout, and :func:`flash_attention_ref`; both give the same
result.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn.ref import flash_attention_ref

launches = 0    # kernel launches since the count was last set to 0
VARIANTS = ("wgmma", "simt")
launches_by_variant = dict.fromkeys(VARIANTS, 0)   # the same, by variant
MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)


def route(dtype: torch.dtype, head_dim: int, ptrs=()) -> str:
    """The kernel variant for these inputs, from their dtype, head width
    and data pointers alone, never from a launch: "wgmma" for bf16 with
    ``head_dim % 16 == 0``, ``head_dim <= 128`` and every pointer 16-byte
    aligned (the wrapper passes contiguous tensors, whose strides are then
    multiples of 32 bytes), else "simt"."""
    if (dtype == torch.bfloat16 and head_dim % 16 == 0
            and 0 < head_dim <= MAX_HEAD_DIM
            and all(p % 16 == 0 for p in ptrs)):
        return "wgmma"
    return "simt"


def _check(q, k, v, q_offset):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention_k wants (B, S, H, D) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, D = q.shape
    if (k.shape[0] != B or v.shape[:3] != k.shape[:3] or k.shape[-1] != D
            or k.shape[2] < 1 or H % k.shape[2] or k.shape[1] < 1):
        raise ValueError(f"flash_attention_k: q {tuple(q.shape)} does not fit "
                         f"k {tuple(k.shape)} and v {tuple(v.shape)} (GQA "
                         f"needs H % Hk == 0, and Skv >= 1)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_k wants float32 or bfloat16 of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          q_offset: int = 0) -> torch.Tensor:
    """The plain version in the (B, S, H, D) layout, on any device: the
    reference ``ops.py``'s route through :func:`flash_attention_ref`."""
    B, Sq, H, D = q.shape
    Hk, Dv = k.shape[2], v.shape[-1]
    rep = H // Hk
    kr = k.repeat_interleave(rep, dim=2)
    vr = v.repeat_interleave(rep, dim=2)
    qf = q.transpose(1, 2).reshape(B * H, Sq, D)
    kf = kr.transpose(1, 2).reshape(B * H, -1, D)
    vf = vr.transpose(1, 2).reshape(B * H, -1, Dv)
    out = flash_attention_ref(qf, kf, vf, causal=causal, q_offset=q_offset)
    return out.reshape(B, H, Sq, Dv).transpose(1, 2)


def flash_attention_k(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, Hk, D|Dv) with H % Hk == 0 ->
    (B, Sq, H, Dv) in q's dtype: ``softmax(q kᵀ D^-0.5) v`` per head,
    causal with query i at position ``q_offset + i``."""
    global launches
    _check(q, k, v, q_offset)
    B, Sq, H, D = q.shape
    Hk, Dv = k.shape[2], v.shape[-1]
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_k runs on cuda or cpu, not "
                         f"{q.device}")
    if Dv != D:
        raise NotImplementedError(
            f"flash_attn kernel needs Dv == D (got D={D}, Dv={Dv}); "
            f"MLA's value width comes with the MLA slice")
    if D > MAX_HEAD_DIM:
        raise NotImplementedError(f"flash_attn kernel takes D <= "
                                  f"{MAX_HEAD_DIM}, got {D}")
    from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda

    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if B * H > 65535:
        raise ValueError(f"flash_attn kernel takes B*H <= 65535, got {B * H}")
    if out.numel():
        variant = route(q.dtype, D, (q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), out.data_ptr()))
        flash_attn_cuda(q, k, v, out, causal, int(q_offset), variant)
        launches += 1
        launches_by_variant[variant] += 1
    return out
