"""Vertex partitioners.

The paper partitions with Metis (multilevel k-way). Offline stand-ins:

* ``block``    — contiguous id blocks (good for lattice/road graphs whose ids
                 are already spatial).
* ``bfs``      — Metis-lite: grow ``ndev`` regions by round-robin BFS from
                 spread-out seeds; minimizes cut on community graphs without
                 external deps.
* ``hash``     — worst-case scatter (ablation baseline: maximal cut).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.storage import (DeviceGraph, Graph, PartitionedGraph,
                                       build_partitioned, device_graph)


def assign_block(graph: Graph, ndev: int) -> np.ndarray:
    per = -(-graph.n // ndev)
    return (np.arange(graph.n) // per).astype(np.int32)


def assign_hash(graph: Graph, ndev: int) -> np.ndarray:
    # splitmix-style integer hash for a deterministic scatter
    v = np.arange(graph.n, dtype=np.uint64)
    v = (v ^ (v >> 30)) * np.uint64(0xBF58476D1CE4E5B9)
    v = (v ^ (v >> 27)) * np.uint64(0x94D049BB133111EB)
    v = v ^ (v >> 31)
    return (v % np.uint64(ndev)).astype(np.int32)


def assign_bfs(graph: Graph, ndev: int, seed: int = 0) -> np.ndarray:
    """Round-robin multi-seed BFS growth with per-part capacity (Metis-lite)."""
    n = graph.n
    rng = np.random.default_rng(seed)
    cap = -(-n // ndev)
    assignment = np.full(n, -1, dtype=np.int32)
    # spread seeds: random start, then farthest-point-ish via BFS layers
    seeds = [int(rng.integers(n))]
    dist = np.full(n, np.iinfo(np.int32).max, dtype=np.int64)
    for _ in range(ndev - 1):
        frontier = [seeds[-1]]
        dist[seeds[-1]] = 0
        d = 0
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for w in graph.neighbors(u):
                    if dist[w] > d:
                        dist[w] = d
                        nxt.append(int(w))
            frontier = nxt
        seeds.append(int(np.argmax(dist)))
    counts = np.zeros(ndev, dtype=np.int64)
    frontiers: list[list[int]] = [[] for _ in range(ndev)]
    for t, s in enumerate(seeds):
        if assignment[s] < 0:
            assignment[s] = t
            counts[t] += 1
            frontiers[t] = [s]
    # round-robin growth
    active = True
    while active:
        active = False
        for t in range(ndev):
            if counts[t] >= cap or not frontiers[t]:
                continue
            nxt: list[int] = []
            for u in frontiers[t]:
                for w in graph.neighbors(u):
                    if assignment[w] < 0 and counts[t] < cap:
                        assignment[w] = t
                        counts[t] += 1
                        nxt.append(int(w))
            frontiers[t] = nxt
            if nxt:
                active = True
    # orphans (disconnected remainder): fill least-loaded parts
    for v in np.flatnonzero(assignment < 0):
        t = int(np.argmin(counts))
        assignment[v] = t
        counts[t] += 1
    return assignment


_METHODS = {"block": assign_block, "hash": assign_hash, "bfs": assign_bfs}


def partition(graph: Graph, ndev: int, method: str = "bfs",
              max_degree: int | None = None, **kw) -> PartitionedGraph:
    if method not in _METHODS:
        raise KeyError(f"unknown partition method {method!r}: {list(_METHODS)}")
    assignment = _METHODS[method](graph, ndev, **kw) if method == "bfs" \
        else _METHODS[method](graph, ndev)
    return build_partitioned(graph, ndev, assignment, max_degree=max_degree)


def partition_device(graph: Graph, ndev: int, method: str = "bfs",
                     fmt: str = "dense", max_degree: int | None = None,
                     device=None, block: tuple[int, int] | None = None,
                     **kw) -> tuple[PartitionedGraph, DeviceGraph]:
    """Partition and export in one go: the host-side partition plus its
    on-device adjacency in the registered storage format ``fmt`` (every
    machine, or only ``block = (dev0, nloc)``)."""
    pg = partition(graph, ndev, method=method, max_degree=max_degree, **kw)
    return pg, device_graph(pg, fmt, device, block)


def edge_cut(graph: Graph, assignment: np.ndarray) -> float:
    """Fraction of edges crossing partitions (quality metric)."""
    e = graph.edge_array()
    cut = np.count_nonzero(assignment[e[:, 0]] != assignment[e[:, 1]])
    return cut / max(len(e), 1)
