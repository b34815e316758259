"""The model stack of the port: the LM transformer for serving (dense
GQA and MoE).  The GNN and recsys models come with their slices."""
from repro_torch.models.layers import flash_attention, moe_block, rms_norm
from repro_torch.models.transformer import (Block, CacheSpec, TransformerLM,
                                            cache_spec, decode_step,
                                            init_cache, init_lm_params,
                                            lm_forward, prefill)

__all__ = [
    "Block", "CacheSpec", "TransformerLM", "cache_spec", "decode_step",
    "init_cache", "init_lm_params", "lm_forward", "prefill",
    "flash_attention", "moe_block", "rms_norm",
]
