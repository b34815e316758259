"""Plain PyTorch version of the moe_gemm kernel: the reference's
``moe_gemm_ref`` (the CPU path, and what the CUDA kernel is held against
on the card)."""
import torch
import torch.nn.functional as F


def moe_gemm_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                 wd: torch.Tensor) -> torch.Tensor:
    """x (E, C, d); wg/wu (E, d, f); wd (E, f, d) -> (E, C, d) in x's
    dtype: ``(silu(x @ wg) * (x @ wu)) @ wd`` per expert, both products
    accumulated in float32 and ``h`` rounded to x's dtype in between."""
    g = torch.einsum("ecd,edf->ecf", x.float(), wg.float())
    u = torch.einsum("ecd,edf->ecf", x.float(), wu.float())
    h = (F.silu(g) * u).to(x.dtype)
    return torch.einsum("ecf,efd->ecd", h.float(), wd.float()).to(x.dtype)
