"""flash-attention entry points in the model's (B, S, H, D) layout: the
CUDA kernels on the card, the plain PyTorch versions on the CPU.

The tensor's device decides.  A CUDA tensor launches the kernel or
raises — there is no fallback — and each launch adds one to
:data:`launches`, so a run can show that its main path went through the
kernel.  Which of the kernel's variants runs is decided before the
launch by :func:`route`, from dtype, head widths and alignment alone,
and counted in :data:`launches_by_variant`: "wgmma" (bf16 on the tensor
cores, TMA-fed) or "simt" (f32 on the CUDA cores, and every other
shape).  q and k share the head width D <= 192 (:data:`MAX_HEAD_DIM`);
v's width Dv <= 128 (:data:`MAX_V_DIM`) may differ from it, as MLA's
does (D = 192, Dv = 128).  The kernel reads the (B, S, H, D|Dv) tensors
in place and indexes the kv head of query head ``h`` as ``h // (H //
Hk)``.  A CPU tensor
takes the reference's ``ops.py`` route: GQA broadcast by ``repeat``, the
(B·H, S, D) layout, and :func:`flash_attention_ref`; both give the same
result.

Training goes through :class:`FlashAttention`, a
``torch.autograd.Function`` (:func:`flash_attention_ad` applies it when an
input needs a gradient): its forward is :func:`flash_attention_k` with the
row log-sum-exp ``lse`` written too, its backward
:func:`flash_attention_bwd_k`, which on the card launches the three
kernels of ``csrc/flash_attn_bwd.cu`` ("delta", "dkdv", "dq"; one launch
each, counted in :data:`bwd_launches`; dkdv and dq through the variant
:func:`route_bwd` picks, "wgmma" or "simt", counted in
:data:`bwd_launches_by_variant`) and on the CPU runs
:func:`flash_attention_bwd_ref`.  Both functions are looked up when the
Function runs, so a caller that swaps them for their plain versions
(``chip_smoke.py``'s plain path) swaps the training path too.  A tensor
on the ``meta`` device (a shape check, no data) runs the plain versions
too, and launches nothing.  The
backward kernels take the forward's widths: D <= 192
(:data:`BWD_MAX_HEAD_DIM`) and Dv <= 128 (:data:`BWD_MAX_V_DIM`).
"""
from __future__ import annotations

import torch

from repro_torch.device import PLAIN_DEVICES
from repro_torch.kernels.flash_attn.ref import (flash_attention_bwd_ref,
                                                flash_attention_ref)

launches = 0    # kernel launches since the count was last set to 0
VARIANTS = ("wgmma", "simt")
launches_by_variant = dict.fromkeys(VARIANTS, 0)   # the same, by variant
BWD_KERNELS = ("delta", "dkdv", "dq")
bwd_launches = dict.fromkeys(BWD_KERNELS, 0)   # backward launches, by kernel
BWD_VARIANTS = ("wgmma", "simt")
# launches of dkdv and dq by the variant route_bwd picked (two a backward)
bwd_launches_by_variant = dict.fromkeys(BWD_VARIANTS, 0)
MAX_HEAD_DIM = 192      # q/k head width the forward kernels take
MAX_V_DIM = 128         # v head width the forward kernels take
BWD_MAX_HEAD_DIM = 192  # q/k head width the backward kernels take
BWD_MAX_V_DIM = 128     # v head width the backward kernels take
DTYPES = (torch.float32, torch.bfloat16)


def route(dtype: torch.dtype, head_dim: int, ptrs=(),
          v_dim: int | None = None) -> str:
    """The kernel variant for these inputs, from their dtype, head widths
    (``v_dim``, v's, defaults to ``head_dim``) and data pointers alone,
    never from a launch: "wgmma" for bf16 with both widths multiples of
    16, ``head_dim <= 192``, ``v_dim <= 128`` and every pointer 16-byte
    aligned (the wrapper passes contiguous tensors, whose strides are then
    multiples of 32 bytes), else "simt"."""
    v_dim = head_dim if v_dim is None else v_dim
    if (dtype == torch.bfloat16 and head_dim % 16 == 0 and v_dim % 16 == 0
            and 0 < head_dim <= MAX_HEAD_DIM and 0 < v_dim <= MAX_V_DIM
            and all(p % 16 == 0 for p in ptrs)):
        return "wgmma"
    return "simt"


def route_bwd(dtype: torch.dtype, head_dim: int, ptrs=(),
              v_dim: int | None = None) -> str:
    """The variant of the dkdv and dq backward kernels, from dtype, head
    widths (``v_dim``, v's, defaults to ``head_dim``) and data pointers
    alone: "wgmma" (the tensor cores, TMA-fed) for bf16 with both widths
    multiples of 16, ``head_dim <= 192``, ``v_dim <= 128`` and every
    pointer 16-byte aligned, else "simt"."""
    v_dim = head_dim if v_dim is None else v_dim
    if (dtype == torch.bfloat16 and head_dim % 16 == 0 and v_dim % 16 == 0
            and 0 < head_dim <= BWD_MAX_HEAD_DIM
            and 0 < v_dim <= BWD_MAX_V_DIM
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
                          q_offset: int = 0, return_lse: bool = False):
    """The plain version in the (B, S, H, D) layout, on any device: the
    reference ``ops.py``'s route through :func:`flash_attention_ref`.
    With ``return_lse`` also the rows' log-sum-exp, (B, H, Sq)."""
    B, Sq, H, D = q.shape
    Hk, Dv = k.shape[2], v.shape[-1]
    rep = H // Hk
    kr = k.repeat_interleave(rep, dim=2)
    vr = v.repeat_interleave(rep, dim=2)
    qf = q.transpose(1, 2).reshape(B * H, Sq, D)
    kf = kr.transpose(1, 2).reshape(B * H, -1, D)
    vf = vr.transpose(1, 2).reshape(B * H, -1, Dv)
    out = flash_attention_ref(qf, kf, vf, causal=causal, q_offset=q_offset,
                              return_lse=return_lse)
    if not return_lse:
        return out.reshape(B, H, Sq, Dv).transpose(1, 2)
    out, lse = out
    return out.reshape(B, H, Sq, Dv).transpose(1, 2), lse.reshape(B, H, Sq)


def flash_attention_k(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, q_offset: int = 0,
                      return_lse: bool = False):
    """q (B, Sq, H, D), k/v (B, Skv, Hk, D|Dv) with H % Hk == 0 ->
    (B, Sq, H, Dv) in q's dtype: ``softmax(q kᵀ D^-0.5) v`` per head,
    causal with query i at position ``q_offset + i``.  With
    ``return_lse`` also ``lse`` (B, H, Sq) float32, each row's
    log-sum-exp of its scaled scores, written by the same launch."""
    global launches
    _check(q, k, v, q_offset)
    B, Sq, H, D = q.shape
    Hk, Dv = k.shape[2], v.shape[-1]
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_plain(q, k, v, causal, q_offset, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_k runs on cuda or cpu, not "
                         f"{q.device}")
    if D > MAX_HEAD_DIM or Dv > MAX_V_DIM:
        raise NotImplementedError(f"flash_attn kernel takes D <= "
                                  f"{MAX_HEAD_DIM} and Dv <= {MAX_V_DIM}, "
                                  f"got D={D}, Dv={Dv}")
    from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda

    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B * H > 65535:
        raise ValueError(f"flash_attn kernel takes B*H <= 65535, got {B * H}")
    if out.numel():
        variant = route(q.dtype, D, (q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), out.data_ptr()), Dv)
        flash_attn_cuda(q, k, v, out, causal, int(q_offset), variant, lse)
        launches += 1
        launches_by_variant[variant] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_k(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          o: torch.Tensor, lse: torch.Tensor,
                          do: torch.Tensor, causal: bool = True,
                          q_offset: int = 0):
    """The gradient of :func:`flash_attention_k`: q (B, Sq, H, D); o, do
    (B, Sq, H, Dv); k (B, Skv, Hk, D), v (B, Skv, Hk, Dv); ``lse`` (B, H,
    Sq) float32 from the forward that gave ``o``.  Returns ``(dq, dk,
    dv)`` in q's dtype, dq and dk D wide, dv Dv wide.  A CUDA tensor
    launches the "delta", "dkdv" and "dq" kernels in turn (or raises); a
    CPU tensor runs :func:`flash_attention_bwd_ref`."""
    _check(q, k, v, q_offset)
    B, Sq, H, D = q.shape
    Skv, Hk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if (o.shape != (B, Sq, H, Dv) or do.shape != o.shape
            or o.dtype != q.dtype
            or do.dtype != q.dtype or tuple(lse.shape) != (B, H, Sq)
            or lse.dtype != torch.float32):
        raise ValueError(f"flash_attention_bwd_k: o {tuple(o.shape)} "
                         f"{o.dtype}, do {tuple(do.shape)} {do.dtype}, lse "
                         f"{tuple(lse.shape)} {lse.dtype} do not fit q "
                         f"{tuple(q.shape)} {q.dtype}")
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                       q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_k runs on cuda or cpu, not "
                         f"{q.device}")
    if D > BWD_MAX_HEAD_DIM or Dv > BWD_MAX_V_DIM:
        raise NotImplementedError(f"flash_attn backward kernels take D <= "
                                  f"{BWD_MAX_HEAD_DIM} and Dv <= "
                                  f"{BWD_MAX_V_DIM}, got D={D}, Dv={Dv}")
    if B * H > 65535:
        raise ValueError(f"flash_attn kernels take B*H <= 65535, got {B * H}")
    from repro_torch.kernels.flash_attn.kernel import flash_attn_bwd_cuda

    q, k, v, o, lse, do = (t.contiguous() for t in (q, k, v, o, lse, do))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if not q.numel():        # no query: no gradient reaches k or v
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    variant = route_bwd(q.dtype, D, [t.data_ptr() for t in
                                     (q, k, v, do, lse, delta, dq, dk, dv)],
                        Dv)
    for kernel, outs in (("delta", ()), ("dkdv", (dk, dv)), ("dq", (dq,))):
        flash_attn_bwd_cuda(kernel, q, k, v, o, lse, do, delta, outs, causal,
                            int(q_offset), variant)
        bwd_launches[kernel] += 1
        if kernel != "delta":
            bwd_launches_by_variant[variant] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable :func:`flash_attention_k`: the forward saves q, k,
    v, the output and ``lse``; the backward is
    :func:`flash_attention_bwd_k`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int):
        o, lse = flash_attention_k(q, k, v, causal=causal,
                                   q_offset=q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_k(q, k, v, o, lse, do.contiguous(),
                                           ctx.causal, ctx.q_offset)
        return dq, dk, dv, None, None


def flash_attention_ad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """:func:`flash_attention_k`, differentiable: through
    :class:`FlashAttention` when gradients are on and an input requires
    one, else the plain call (serving asks for no ``lse``)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, q_offset)
    return flash_attention_k(q, k, v, causal=causal, q_offset=q_offset)
