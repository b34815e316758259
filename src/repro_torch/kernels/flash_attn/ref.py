"""Plain PyTorch versions of the flash-attention kernels: the forward, the
naive masked softmax of the reference's ``flash_attn/ref.py``, and its
backward in FlashAttention-2's form (the CPU path, and what the CUDA
kernels are held against on the card).  Both work a chunk of queries at a
time, so neither holds the whole (Sq, Skv) score matrix."""
import torch


def _acc(dtype: torch.dtype) -> torch.dtype:
    """float64 inputs are computed in float64, everything else in float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _causal_keep(c0: int, c1: int, Skv: int, q_offset: int,
                 device) -> torch.Tensor:
    """(c1 - c0, Skv): query i keeps key j when ``q_offset + i >= j``."""
    qpos = torch.arange(c0, c1, device=device)[:, None] + q_offset
    return qpos >= torch.arange(Skv, device=device)[None, :]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0,
                        return_lse: bool = False, q_chunk: int = 1024):
    """q (BH, Sq, D), k/v (BH, Skv, D|Dv) -> (BH, Sq, Dv) in q's dtype, and
    with ``return_lse`` also each row's log-sum-exp of its scaled scores,
    (BH, Sq) in float32.  Scores and softmax in float32; the causal mask
    keeps key j for query i when ``q_offset + i >= j`` (aligned at
    position 0 by default).  ``q_chunk`` queries at a time, each against
    all keys, so the chunks change the memory, not the result."""
    D = q.shape[-1]
    Sq, Skv = q.shape[1], k.shape[1]
    acc = _acc(q.dtype)
    kf, vf = k.to(acc), v.to(acc)
    outs, lses = [], []
    for c0 in range(0, max(Sq, 1), q_chunk):
        c1 = min(c0 + q_chunk, Sq)
        s = torch.einsum("bqd,bkd->bqk", q[:, c0:c1].to(acc), kf) * D ** -0.5
        if causal:
            keep = _causal_keep(c0, c1, Skv, q_offset, q.device)
            s = s.masked_fill(~keep[None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bqk,bkd->bqd", p, vf).to(q.dtype))
        if return_lse:
            lses.append(torch.logsumexp(s, dim=-1))
    out = torch.cat(outs, dim=1)
    return (out, torch.cat(lses, dim=1)) if return_lse else out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            causal: bool = True, q_offset: int = 0,
                            q_chunk: int = 1024):
    """The gradient of :func:`flash_attention_ref` in the model's layout:
    q, o, do (B, Sq, H, D); k, v (B, Skv, Hk, D) with H % Hk == 0; lse
    (B, H, Sq), the forward's.  Returns ``(dq, dk, dv)`` in the inputs'
    dtypes, FlashAttention-2's form in float32: delta = rowsum(dO * O);
    per chunk of queries P = exp(s - lse) recomputed from q, k and lse,
    dV += P^T dO, dS = P * (dO V^T - delta), dQ = dS K * D^-0.5,
    dK += dS^T Q * D^-0.5.  GQA's dK and dV are summed over the H // Hk
    query heads of each kv head."""
    B, Sq, H, D = q.shape
    Skv, Hk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    rep = H // Hk
    acc = _acc(q.dtype)
    scale = D ** -0.5
    kr = k.to(acc).repeat_interleave(rep, dim=2)            # (B, Skv, H, D)
    vr = v.to(acc).repeat_interleave(rep, dim=2)
    delta = (do.to(acc) * o.to(acc)).sum(-1).transpose(1, 2)   # (B, H, Sq)
    dkr, dvr = torch.zeros_like(kr), torch.zeros_like(vr)
    dqs = []
    for c0 in range(0, max(Sq, 1), q_chunk):
        c1 = min(c0 + q_chunk, Sq)
        qc, doc = q[:, c0:c1].to(acc), do[:, c0:c1].to(acc)
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kr) * scale
        p = torch.exp(s - lse[:, :, c0:c1, None].to(acc))
        if causal:
            keep = _causal_keep(c0, c1, Skv, q_offset, q.device)
            p = p.masked_fill(~keep, 0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", doc, vr)
        ds = p * (dp - delta[:, :, c0:c1, None])
        dqs.append(torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale)
        dkr += torch.einsum("bhqk,bqhd->bkhd", ds, qc)
        dvr += torch.einsum("bhqk,bqhd->bkhd", p, doc)
    dq = torch.cat(dqs, dim=1).to(q.dtype)
    dk = (dkr * scale).view(B, Skv, Hk, rep, D).sum(3).to(k.dtype)
    dv = dvr.view(B, Skv, Hk, rep, Dv).sum(3).to(v.dtype)
    return dq, dk, dv
