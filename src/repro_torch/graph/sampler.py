"""Neighbor sampler for sampled-training GNN shapes (``minibatch_lg``).

GraphSAGE-style fanout sampling: for a seed batch, sample ``fanout[h]``
neighbors per node per hop, emitting a *fixed-shape padded subgraph*
(the same buffer sizes every step): node list, edge (src,dst) pairs into
the local node numbering, and a validity mask. This is a real sampler (uniform
without replacement when degree allows), not a stub.  A copy of the
reference's ``graph/sampler.py`` (pure numpy): the same graph, seeds and
``np.random.Generator`` give the same arrays.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.graph.storage import Graph


@dataclass
class SampledSubgraph:
    nodes: np.ndarray       # (max_nodes,) int32 global ids (padded with -1)
    n_nodes: int
    edge_src: np.ndarray    # (max_edges,) int32 local index
    edge_dst: np.ndarray    # (max_edges,) int32 local index
    edge_mask: np.ndarray   # (max_edges,) bool
    seed_mask: np.ndarray   # (max_nodes,) bool — True for the seed batch rows

    @property
    def max_nodes(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def max_edges(self) -> int:
        return int(self.edge_src.shape[0])


def sample_capacities(batch_nodes: int, fanout: tuple[int, ...]) -> tuple[int, int]:
    """Static (max_nodes, max_edges) for a given batch/fanout — shared by the
    sampler and the dry-run input_specs."""
    layer = batch_nodes
    max_nodes = batch_nodes
    max_edges = 0
    for f in fanout:
        max_edges += layer * f
        layer = layer * f
        max_nodes += layer
    return max_nodes, max_edges


def sample_neighbors(graph: Graph, seeds: np.ndarray, fanout: tuple[int, ...],
                     rng: np.random.Generator) -> SampledSubgraph:
    seeds = np.asarray(seeds, dtype=np.int64)
    max_nodes, max_edges = sample_capacities(len(seeds), fanout)

    node_of: dict[int, int] = {}
    nodes: list[int] = []

    def local(v: int) -> int:
        if v not in node_of:
            node_of[v] = len(nodes)
            nodes.append(v)
        return node_of[v]

    for s in seeds:
        local(int(s))
    edge_src: list[int] = []
    edge_dst: list[int] = []
    frontier = [int(s) for s in seeds]
    for f in fanout:
        nxt: list[int] = []
        for u in frontier:
            nbrs = graph.neighbors(u)
            if len(nbrs) == 0:
                continue
            if len(nbrs) <= f:
                pick = nbrs
            else:
                pick = rng.choice(nbrs, size=f, replace=False)
            lu = local(u)
            for w in pick:
                lw = local(int(w))
                # message flows neighbor -> node being updated
                edge_src.append(lw)
                edge_dst.append(lu)
                nxt.append(int(w))
        frontier = nxt

    n_nodes = len(nodes)
    n_edges = len(edge_src)
    nodes_arr = np.full(max_nodes, -1, dtype=np.int32)
    nodes_arr[:n_nodes] = np.asarray(nodes, dtype=np.int32)
    src = np.zeros(max_edges, dtype=np.int32)
    dst = np.zeros(max_edges, dtype=np.int32)
    mask = np.zeros(max_edges, dtype=bool)
    src[:n_edges] = edge_src
    dst[:n_edges] = edge_dst
    mask[:n_edges] = True
    seed_mask = np.zeros(max_nodes, dtype=bool)
    seed_mask[:len(seeds)] = True
    return SampledSubgraph(nodes=nodes_arr, n_nodes=n_nodes, edge_src=src,
                           edge_dst=dst, edge_mask=mask, seed_mask=seed_mask)
