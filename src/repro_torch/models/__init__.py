"""The model stack of the port: the LM transformer for serving and
training (dense GQA and MoE) and the GNNs (GraphCast, SchNet, PNA, GAT)
for serving and training.  The recsys models come with their slice."""
from repro_torch.models.gnn import (GNNModel, GraphBatch, gat_forward,
                                    gnn_forward, gnn_loss, graphcast_forward,
                                    init_gat, init_gnn, init_graphcast,
                                    init_pna, init_schnet, pna_forward,
                                    schnet_forward)
from repro_torch.models.layers import flash_attention, moe_block, rms_norm
from repro_torch.models.transformer import (Block, CacheSpec, TransformerLM,
                                            cache_spec, chunked_xent,
                                            decode_step, init_cache,
                                            init_lm_params, lm_forward,
                                            lm_forward_hidden, lm_loss,
                                            prefill, sharded_xent)

__all__ = [
    "Block", "CacheSpec", "TransformerLM", "cache_spec", "decode_step",
    "init_cache", "init_lm_params", "lm_forward", "prefill",
    "lm_forward_hidden", "lm_loss", "chunked_xent", "sharded_xent",
    "flash_attention", "moe_block", "rms_norm",
    "GNNModel", "GraphBatch", "gnn_forward", "gnn_loss", "init_gnn",
    "gat_forward",
    "graphcast_forward", "pna_forward", "schnet_forward", "init_gat",
    "init_graphcast", "init_pna", "init_schnet",
]
