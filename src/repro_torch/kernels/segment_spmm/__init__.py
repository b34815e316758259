"""Segment sum of edge messages by destination node, the GNN message
aggregation: the port of ``segment_spmm_pallas`` (CUDA source, ctypes
binding, plain PyTorch version, wrapper)."""
