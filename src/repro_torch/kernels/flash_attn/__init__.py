"""Causal or non-causal softmax attention with an online softmax: the
port of ``flash_attention_pallas`` (CUDA source, ctypes binding, plain
PyTorch version, wrapper)."""
