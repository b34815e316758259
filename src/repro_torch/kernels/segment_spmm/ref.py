"""Plain PyTorch versions of the segment_spmm kernel: the reference's two
oracles (the CPU path, and what the CUDA kernel is held against on the
card).  Both return float32, as the TPU kernel does."""
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
