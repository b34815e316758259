"""Transformer building blocks as plain functions on tensors, one beside
each function of the reference's ``models/layers.py``.

Parameters are dicts of tensors (an :class:`~torch.nn.ParameterDict`
reads the same).  Two functions run hand-written kernels on a CUDA
tensor: :func:`flash_attention` (``kernels.flash_attn``) and the expert
FFN of :func:`moe_block` (``kernels.moe_gemm``).  On a CPU tensor they
run the kernels' plain PyTorch versions.  Both are differentiable through
a ``torch.autograd.Function`` whose backward is a kernel too (on the CPU
its plain version), so training runs the same path as serving.  The
projections, norms, rope, the router and :func:`decode_attention` are
plain PyTorch with plain autograd on both, as the reference leaves them
to XLA; so are the MLA functions apart from prefill's attention, which
is :func:`flash_attention` at D = qk_nope + qk_rope and Dv = v_head_dim
(the absorbed decode, like the reference's, runs outside any kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import TransformerConfig
from repro_torch.distributed import ctx
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.moe_gemm import ops as moe_ops


def _init(gen: torch.Generator, shape, scale=None, dtype=torch.float32,
          device=None) -> torch.Tensor:
    """Normal(0, 1) in float32 times ``scale`` (default
    ``1/sqrt(shape[0])``, the reference's rule), cast to ``dtype``.  On
    the ``meta`` device (a shape-only build: names, shapes and dtypes,
    no storage) an empty tensor, and ``gen`` may be None."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    scale = scale if scale is not None else (1.0 / max(shape[0], 1)) ** 0.5
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


# --------------------------------------------------------------------------- #
# norms / rope / mlp
# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_angles(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """positions (...,) -> (cos, sin) of shape (..., dim//2)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (..., S, D//2) broadcast over heads."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ wg) * (x @ wu)) @ wd


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, Hk, D) with H % Hk == 0 (GQA).

    The flash_attn kernel on a CUDA tensor, its plain version on a CPU
    tensor; differentiable (``flash_ops.flash_attention_ad``).  The
    reference's ``q_chunk``/``kv_chunk`` tiling has no counterpart: the
    kernel tiles itself.  ``q_offset`` is the absolute position of q[0]
    for the causal mask."""
    return flash_ops.flash_attention_ad(q, k, v, causal=causal,
                                        q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length) -> torch.Tensor:
    """Single-token decode: q (B, 1, H, D) against cache (B, S, Hk, D).
    ``length`` masks positions >= current length (int or (B,))."""
    B, _, H, D = q.shape
    _, S, Hk, _ = k_cache.shape
    rep = H // Hk
    kr = k_cache.repeat_interleave(rep, dim=2)
    vr = v_cache.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * D ** -0.5
    pos = torch.arange(S, device=q.device)
    ln = torch.as_tensor(length, device=q.device)
    mask = pos[None, :] < (ln[:, None] if ln.dim() else ln)
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr.float())
    return out.to(q.dtype)


# --------------------------------------------------------------------------- #
# GQA attention block
# --------------------------------------------------------------------------- #
def init_gqa_params(gen: torch.Generator, cfg: TransformerConfig, dtype,
                    device=None) -> dict:
    d, H, Hk, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = dict(
        wq=_init(gen, (d, H * Dh), dtype=dtype, device=device),
        wk=_init(gen, (d, Hk * Dh), dtype=dtype, device=device),
        wv=_init(gen, (d, Hk * Dh), dtype=dtype, device=device),
        wo=_init(gen, (H * Dh, d), dtype=dtype, device=device),
    )
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * Dh,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((Hk * Dh,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((Hk * Dh,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((Dh,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((Dh,), dtype=dtype, device=device)
    return p


def gqa_qkv(p, cfg: TransformerConfig, x, positions):
    """x (B, S, d) -> q (B,S,H,Dh), k/v (B,S,Hk,Dh) with rope (+qk_norm)."""
    B, S, _ = x.shape
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, Hk, Dh)
    v = v.reshape(B, S, Hk, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_angles(positions, Dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


# --------------------------------------------------------------------------- #
# MLA (DeepSeek multi-head latent attention)
# --------------------------------------------------------------------------- #
def init_mla_params(gen: torch.Generator, cfg: TransformerConfig, dtype,
                    device=None) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim

    def w(shape):
        return _init(gen, shape, dtype=dtype, device=device)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    return dict(
        w_dq=w((d, m.q_lora_rank)), q_norm=ones(m.q_lora_rank),
        w_uq=w((m.q_lora_rank, H * qk_head)),
        w_dkv=w((d, m.kv_lora_rank)), kv_norm=ones(m.kv_lora_rank),
        w_kr=w((d, m.qk_rope_head_dim)),
        w_uk=w((m.kv_lora_rank, H * m.qk_nope_head_dim)),
        w_uv=w((m.kv_lora_rank, H * m.v_head_dim)),
        wo=w((H * m.v_head_dim, d)))


def mla_compress(p, cfg: TransformerConfig, x, positions):
    """x (B,S,d) -> (c_kv (B,S,r), k_rope (B,S,1,Dr)) — what the KV cache
    stores (the MLA memory saving)."""
    m = cfg.mla
    c_kv = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    k_r = (x @ p["w_kr"]).reshape(*x.shape[:-1], 1, m.qk_rope_head_dim)
    cos, sin = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    return c_kv, apply_rope(k_r, cos, sin)


def mla_queries(p, cfg: TransformerConfig, x, positions):
    """x (B,S,d) -> (q_nope (B,S,H,Dn), q_rope (B,S,H,Dr)), rope applied."""
    m = cfg.mla
    B, S, _ = x.shape
    cq = rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(B, S, cfg.n_heads,
                                 m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    cos, sin = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def mla_expand_kv(p, cfg: TransformerConfig, c_kv):
    """Naive execution: materialize per-head k_nope / v from the latent."""
    m = cfg.mla
    B, S, _ = c_kv.shape
    H = cfg.n_heads
    k_nope = (c_kv @ p["w_uk"]).reshape(B, S, H, m.qk_nope_head_dim)
    v = (c_kv @ p["w_uv"]).reshape(B, S, H, m.v_head_dim)
    return k_nope, v


def mla_absorbed_decode(p, cfg: TransformerConfig, x, c_kv_cache, kr_cache,
                        length, positions):
    """Weight-absorbed MLA decode: attention runs in the latent space, with
    no per-head K/V over the cache (W_uk folded into the queries, W_uv
    applied after).  x (B,1,d); c_kv_cache (B,S,r); kr_cache (B,S,1,Dr);
    ``length`` masks positions >= it (int or (B,)).  The reference's dtype
    sequence: ``q_lat`` in x's dtype, both score products and ``o_lat``
    summed in float32 (against the float32 cache), ``o_lat`` cast back to
    x's dtype before W_uv."""
    m = cfg.mla
    B, S, r = c_kv_cache.shape
    H = cfg.n_heads
    q_nope, q_rope = mla_queries(p, cfg, x, positions)       # (B,1,H,*)
    w_uk = p["w_uk"].reshape(r, H, m.qk_nope_head_dim)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)     # (B,1,H,r)
    c32 = c_kv_cache.to(q_lat.dtype).float()
    s_lat = torch.einsum("bqhr,bkr->bhqk", q_lat.float(), c32)
    s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                          kr_cache[:, :, 0].to(q_rope.dtype).float())
    s = (s_lat + s_rope) * (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    ln = torch.as_tensor(length, device=x.device)
    mask = (torch.arange(S, device=x.device)[None, :]
            < (ln[:, None] if ln.dim() else ln))
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    pattn = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhqk,bkr->bqhr", pattn, c_kv_cache.float())
    w_uv = p["w_uv"].reshape(r, H, m.v_head_dim)
    o = torch.einsum("bqhr,rhd->bqhd", o_lat.to(x.dtype), w_uv)
    return o.reshape(B, 1, H * m.v_head_dim) @ p["wo"]


# --------------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------------- #
def init_moe_params(gen: torch.Generator, cfg: TransformerConfig, dtype,
                    device=None) -> dict:
    mo = cfg.moe
    d, E, f = cfg.d_model, mo.n_experts, mo.d_expert
    p = dict(
        router=_init(gen, (d, E), dtype=torch.float32, device=device),
        wg=_init(gen, (E, d, f), dtype=dtype, device=device),
        wu=_init(gen, (E, d, f), dtype=dtype, device=device),
        wd=_init(gen, (E, f, d), dtype=dtype, device=device),
    )
    if mo.router_aux_free:
        p["router_bias"] = torch.zeros((E,), dtype=torch.float32,
                                       device=device)
    if mo.n_shared:
        fs = f * mo.n_shared
        p["shared_wg"] = _init(gen, (d, fs), dtype=dtype, device=device)
        p["shared_wu"] = _init(gen, (d, fs), dtype=dtype, device=device)
        p["shared_wd"] = _init(gen, (fs, d), dtype=dtype, device=device)
    return p


def moe_route(p, cfg: TransformerConfig, xt: torch.Tensor):
    """Router of :func:`moe_block` on xt (T, d): ``(sel (T, k) int64,
    gates (T, k) f32, probs_mean (E,) f32)``, the experts in descending
    score order as ``jax.lax.top_k`` gives them."""
    mo = cfg.moe
    logits = xt.float() @ p["router"]
    if mo.router_aux_free:
        scores = torch.sigmoid(logits)
        _, sel = torch.topk(scores + p["router_bias"], mo.top_k, dim=-1,
                            sorted=True)
        gsel = torch.gather(scores, -1, sel)
        probs_mean = scores.mean(dim=0)
    else:
        probs = torch.softmax(logits, dim=-1)
        gsel, sel = torch.topk(probs, mo.top_k, dim=-1, sorted=True)
        probs_mean = probs.mean(dim=0)
    gates = gsel / (gsel.sum(-1, keepdim=True) + 1e-9)
    return sel, gates, probs_mean


def moe_slots(flat_e: torch.Tensor, C: int):
    """Each (token, expert) pair's slot in its expert's buffer: stable sort
    by expert, so the priority is token order.  Returns ``(slot_e, slot_c,
    keep)``; a pair past the capacity C is dropped (``keep`` False) and
    points at slot (0, C - 1) as in the reference."""
    n = flat_e.numel()
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    first = torch.searchsorted(sorted_e, sorted_e)
    pos_sorted = torch.arange(n, device=flat_e.device) - first
    pos_in_e = torch.empty_like(pos_sorted)
    pos_in_e[sort_idx] = pos_sorted
    keep = pos_in_e < C
    slot_e = torch.where(keep, flat_e, 0)
    slot_c = torch.where(keep, pos_in_e, C - 1)
    return slot_e, slot_c, keep


def _slot_owners(dest: torch.Tensor, keep: torch.Tensor,
                 n_slots: int) -> torch.Tensor:
    """(n_slots,) the (token, expert) pair that owns each slot of the
    experts' buffer, or ``n_pairs`` for an empty slot.  Each dropped pair
    writes a place of its own past the buffer, so no index repeats."""
    n = dest.numel()
    pair = torch.arange(n, device=dest.device)
    owner = torch.full((n_slots + n,), n, dtype=torch.long,
                       device=dest.device)
    owner[torch.where(keep, dest, n_slots + pair)] = pair
    return owner[:n_slots]


def _pad_row(t: torch.Tensor) -> torch.Tensor:
    """``t`` (n, d) with a row of zeros after it."""
    return torch.cat([t, t.new_zeros((1, t.shape[1]))])


class _Dispatch(torch.autograd.Function):
    """The dispatch of :func:`moe_block`: the experts' buffer (E*C, d) as a
    gather of each slot's owner's token row (zeros for an empty slot),
    whose backward is a gather too: each pair reads its slot's gradient
    (``dest``: a kept pair's slot, the zero row past the buffer for a
    dropped one) and each token sums its k pairs in order.  Autograd's
    own backward of ``index_copy_`` (and, with deterministic algorithms
    on, the copy itself) runs an index kernel that serialises on the dump
    row that every dropped pair writes."""

    @staticmethod
    def forward(ctx, xt, owner, dest, k: int):
        n = dest.numel()
        token = torch.where(owner < n, owner // k, xt.shape[0])
        ctx.save_for_backward(dest)
        ctx.k = k
        return _pad_row(xt)[token]

    @staticmethod
    def backward(ctx, grad):
        dest, = ctx.saved_tensors
        pairs = _pad_row(grad)[dest]                      # (T*k, d)
        return (pairs.view(-1, ctx.k, pairs.shape[1]).sum(dim=1), None,
                None, None)


class _TakeSlots(torch.autograd.Function):
    """The combine of :func:`moe_block`: ``y_flat[slot]``, each (token, expert)
    pair's row of the experts' output, with a gather-shaped backward: each
    slot gathers the gradient of the one pair that owns it (``owner``), or
    zero.  Autograd's own backward of this gather adds every pair's
    gradient into its slot with an index scatter, which serialises on the
    slot (0, C - 1) that every dropped pair reads; the dropped pairs'
    gradients are zero (``moe_block`` masks their rows), so both give the
    same sums."""

    @staticmethod
    def forward(ctx, y_flat, slot, owner):
        ctx.save_for_backward(owner)
        return y_flat[slot]

    @staticmethod
    def backward(ctx, grad):
        owner, = ctx.saved_tensors
        return _pad_row(grad)[owner], None, None


def moe_block(p, cfg: TransformerConfig, x: torch.Tensor):
    """Capacity-based top-k dispatch. x (B, S, d) -> (y, aux_loss).
    Dropped tokens (over capacity) fall back to 0 (plus the shared
    expert, if any) — standard capacity semantics.  The expert FFN over
    the (E, C, d) buffer is the moe_gemm kernel on a CUDA tensor and its
    plain version on a CPU tensor, differentiable
    (``moe_ops.moe_gemm_ad``).  Every step is deterministic, its backward
    too: the dispatch (:class:`_Dispatch`) gathers each slot's owner's
    row, the combine (:class:`_TakeSlots`) gathers each pair's output
    row, each with a gather for a backward, and each token sums its k
    expert outputs in slot order.
    The router's gradient flows through the gates and ``probs_mean``;
    ``frac_tok`` counts and carries none, as in the reference."""
    fl = ctx.CURRENT
    mo = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = mo.n_experts, mo.top_k
    xt = x.reshape(T, d)
    sel, gates, probs_mean = moe_route(p, cfg, xt)

    cf = fl.moe_capacity_factor or mo.capacity_factor
    C = max(int(T * k / E * cf), 1)
    flat_e = sel.reshape(-1)                                  # (T*k,)
    flat_g = gates.reshape(-1)
    slot_e, slot_c, keep = moe_slots(flat_e, C)
    slot = slot_e * C + slot_c
    # kept pairs own distinct slots; dropped pairs go to a dump row past
    # the buffer, which the reference's add of 0 to slot (0, C-1) equals
    dest = torch.where(keep, slot, E * C)
    owner = _slot_owners(dest, keep, E * C)
    buf = _Dispatch.apply(xt, owner, dest, k).view(E, C, d)
    y_e = moe_ops.moe_gemm_ad(buf, p["wg"], p["wu"], p["wd"])
    y_tok = _TakeSlots.apply(y_e.view(E * C, d), slot, owner)  # (T*k, d)
    y_tok = torch.where(keep[:, None], y_tok, 0) * flat_g[:, None].to(x.dtype)
    y = y_tok.view(T, k, d).sum(dim=1)
    # load-balance aux (Switch-style); for aux-free routing it is only
    # reported.  Tokens are counted into a fixed (E,) buffer, so no shape
    # depends on the data (bincount's does, which the meta device cannot
    # trace)
    counts = torch.zeros(E, dtype=torch.int64, device=flat_e.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    frac_tok = counts.float() / (T * k)
    aux = E * torch.sum(frac_tok * probs_mean)
    if mo.n_shared:
        y = y + swiglu(xt, p["shared_wg"], p["shared_wu"], p["shared_wd"])
    return y.reshape(B, S, d), aux
