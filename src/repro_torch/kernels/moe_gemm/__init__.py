"""Grouped per-expert SwiGLU FFN over the capacity-dispatched token
buffer: the port of ``moe_gemm_pallas`` (CUDA source, ctypes binding,
plain PyTorch version, wrapper)."""
