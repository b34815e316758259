"""Plain PyTorch version of the flash-attention kernel: the naive masked
softmax of the reference's ``flash_attn/ref.py`` (the CPU path, and what
the CUDA kernel is held against on the card)."""
import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (BH, Sq, D), k/v (BH, Skv, D|Dv) -> (BH, Sq, Dv) in q's dtype.
    Scores and softmax in float32; the causal mask keeps key j for query
    i when ``q_offset + i >= j`` (aligned at position 0 by default)."""
    D = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * D ** -0.5
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        mask = qpos >= torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(~mask[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
