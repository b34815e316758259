"""GAT [arXiv:1710.10903] — 2 layers, d_hidden=8 per head, 8 heads, attention agg."""
import dataclasses

from repro_torch.configs.base import ArchConfig, GNN_SHAPES, GNNConfig

CONFIG = ArchConfig(
    arch_id="gat-cora",
    model=GNNConfig(
        name="gat-cora", kind="gat",
        n_layers=2, d_hidden=8, n_heads=8, aggregator="attn",
        n_classes=7,
    ),
    shapes=GNN_SHAPES,
    notes="SDDMM edge scores -> segment softmax -> SpMM; ELU between layers.",
)


def reduced() -> GNNConfig:
    return dataclasses.replace(CONFIG.model, n_layers=2, d_hidden=4, n_heads=2)
