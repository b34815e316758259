"""The model stack of the port: the LM transformer for serving and
training (dense GQA, MoE and MLA), the GNNs (GraphCast, SchNet, PNA,
GAT) and DIN with its EmbeddingBag, each for serving and training."""
from repro_torch.models.gnn import (GNNModel, GraphBatch, gat_forward,
                                    gnn_forward, gnn_loss, graphcast_forward,
                                    init_gat, init_gnn, init_graphcast,
                                    init_pna, init_schnet, pna_forward,
                                    schnet_forward)
from repro_torch.models.layers import flash_attention, moe_block, rms_norm
from repro_torch.models.recsys import (DINBatch, DINModel, TableGather,
                                       din_logits, din_loss, din_user_state,
                                       embedding_bag, init_din,
                                       retrieval_scores)
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
    "DINBatch", "DINModel", "TableGather", "din_logits", "din_loss",
    "din_user_state", "embedding_bag", "init_din", "retrieval_scores",
]
