"""Plain PyTorch version of the intersect kernel (the CPU path, and what
the CUDA kernel is held against on the card)."""
import torch


def intersect_ref(a: torch.Tensor, b: torch.Tensor, sentinel: int):
    """a, b (B, M) int32, ``b`` sorted per row -> ``(mask (B, M) bool,
    count (B,) int32)``: ``mask[r, j] = b[r, min(lower_bound(b[r],
    a[r, j]), M - 1)] == a[r, j] and a[r, j] != sentinel``."""
    idx = torch.searchsorted(b, a, out_int32=True)
    idx = idx.clamp_(0, b.shape[-1] - 1)
    mask = (torch.gather(b, -1, idx.long()) == a) & (a != sentinel)
    return mask, mask.sum(dim=-1, dtype=torch.int32)
