"""SchNet [arXiv:1706.08566] — 3 interactions, d=64, 300 RBF, cutoff 10A."""
import dataclasses

from repro_torch.configs.base import ArchConfig, GNN_SHAPES, GNNConfig

CONFIG = ArchConfig(
    arch_id="schnet",
    model=GNNConfig(
        name="schnet", kind="schnet",
        n_layers=3, d_hidden=64, aggregator="sum",
        n_rbf=300, cutoff=10.0,
    ),
    shapes=GNN_SHAPES,
    notes="continuous-filter conv: RBF(dist) -> filter MLP -> elementwise * gathered "
          "features -> segment_sum; positions synthesized for non-molecular graphs.",
)


def reduced() -> GNNConfig:
    return dataclasses.replace(CONFIG.model, n_layers=2, d_hidden=16, n_rbf=20)
