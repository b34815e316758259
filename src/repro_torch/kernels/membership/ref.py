"""Plain PyTorch version of the membership kernel (the CPU path, and what
the CUDA kernel is held against on the card)."""
import torch


def membership_ref(rows: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """rows (B, M) sorted int32 (sentinel-padded); vals (B, K) -> (B, K)
    bool: ``rows[b, min(lower_bound(rows[b], vals[b, k]), M - 1)] ==
    vals[b, k]`` — a sentinel query is "present" in a padded row."""
    idx = torch.searchsorted(rows, vals, out_int32=True)
    idx = idx.clamp_(0, rows.shape[-1] - 1)
    return torch.gather(rows, -1, idx.long()) == vals
