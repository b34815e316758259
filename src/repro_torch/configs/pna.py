"""PNA [arXiv:2004.05718] — 4 layers, d=75, aggregators mean/max/min/std,
scalers identity/amplification/attenuation."""
import dataclasses

from repro_torch.configs.base import ArchConfig, GNN_SHAPES, GNNConfig

CONFIG = ArchConfig(
    arch_id="pna",
    model=GNNConfig(
        name="pna", kind="pna",
        n_layers=4, d_hidden=75,
        aggregators=("mean", "max", "min", "std"),
        scalers=("identity", "amplification", "attenuation"),
    ),
    shapes=GNN_SHAPES,
    notes="4 aggregators x 3 degree-scalers -> 12x towers -> linear mix.",
)


def reduced() -> GNNConfig:
    return dataclasses.replace(CONFIG.model, n_layers=2, d_hidden=16)
