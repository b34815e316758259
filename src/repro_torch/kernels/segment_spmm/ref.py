"""Plain PyTorch versions of the segment_spmm kernel: the reference's two
oracles (the CPU path, and what the CUDA kernel is held against on the
card), both float32 as the TPU kernel returns, and the segment max of
GAT's softmax and PNA's max and min."""
import math

import torch


def segment_spmm_ref(msgs: torch.Tensor, dst_local: torch.Tensor,
                     tn: int) -> torch.Tensor:
    """msgs (n_tiles, TE, D); dst_local (n_tiles, TE) in [0, TN], TN the
    drop slot -> (n_tiles, TN, D) float32: per tile, the sum of its
    messages by local destination."""
    n_tiles, _, d = msgs.shape
    out = torch.zeros((n_tiles, tn + 1, d), dtype=torch.float32,
                      device=msgs.device)
    idx = dst_local.long() + (tn + 1) * torch.arange(
        n_tiles, device=msgs.device)[:, None]
    out.view(-1, d).index_add_(0, idx.reshape(-1),
                               msgs.reshape(-1, d).float())
    return out[:, :tn]


def segment_sum_dense(msgs: torch.Tensor, dst: torch.Tensor,
                      n: int) -> torch.Tensor:
    """msgs (E, D), dst (E,) in [0, n) -> (n, D) float32:
    ``out[v] = sum of msgs[e] over the edges e with dst[e] == v``."""
    out = torch.zeros((n, msgs.shape[1]), dtype=torch.float32,
                      device=msgs.device)
    return out.index_add_(0, dst, msgs.float())


def segment_max(x: torch.Tensor, idx64: torch.Tensor, n: int) -> torch.Tensor:
    """Max of ``x`` (E, ...) by the int64 ``idx64`` into (n, ...); a node
    with no edge gets ``-inf``, as ``jax.ops.segment_max`` gives."""
    out = torch.full((n, *x.shape[1:]), -math.inf, dtype=x.dtype,
                     device=x.device)
    index = idx64.view(-1, *([1] * (x.dim() - 1))).expand_as(x)
    return out.scatter_reduce_(0, index, x, "amax", include_self=False)
