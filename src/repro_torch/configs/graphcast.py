"""GraphCast [arXiv:2212.12794] — encoder-processor-decoder mesh GNN.
16 processor layers, d_hidden=512, mesh_refinement=6, sum aggregator, 227 vars.

For the assigned (arch x shape) cells the processor runs over the *given* graph
(cora / reddit-minibatch / ogb-products / molecule batches); the icosahedral
multi-mesh generator is used by the graphcast example driver."""
import dataclasses

from repro_torch.configs.base import ArchConfig, GNN_SHAPES, GNNConfig

CONFIG = ArchConfig(
    arch_id="graphcast",
    model=GNNConfig(
        name="graphcast", kind="graphcast",
        n_layers=16, d_hidden=512, aggregator="sum",
        mesh_refinement=6, n_vars=227,
    ),
    shapes=GNN_SHAPES,
    notes="encoder-processor-decoder interaction network; edge+node MLPs, residual.",
)


def reduced() -> GNNConfig:
    return dataclasses.replace(CONFIG.model, n_layers=2, d_hidden=32,
                               mesh_refinement=1, n_vars=8)
