"""Graph storage: host-side CSR, device partitioning, and the on-device
adjacency (:class:`DeviceGraph`).

The host half (:class:`Graph`, :class:`PartitionedGraph`,
:func:`build_partitioned`) is a copy of the reference package's numpy
code: an undirected, unlabeled data graph in CSR form with sorted rows,
renumbered device-contiguously so ``owner(v) = v // stride``.

On the card the engine reads adjacency only through :class:`DeviceGraph`:
``rows_at``/``deg_at`` over the stacked ``(ndev, ...)`` layout, returning
sentinel ``n``-padded rows of width ``max_degree``.  The ``ndev`` virtual
machines share one card, so every accessor takes per-device local indices
with a leading ``ndev`` axis — the batch dimension that replaces the
reference's ``jax.vmap`` over devices.  This slice ports the ``dense``
format; ``bucketed`` raises until its slice lands.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass
class Graph:
    """Host-side undirected graph in CSR form (rows sorted ascending)."""

    n: int
    indptr: np.ndarray   # (n+1,) int64
    indices: np.ndarray  # (2E,) int32, row-sorted

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0]) // 2

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max()) if self.n else 0

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def has_edge(self, u: int, v: int) -> bool:
        row = self.neighbors(u)
        i = np.searchsorted(row, v)
        return bool(i < row.shape[0] and row[i] == v)

    def edge_array(self) -> np.ndarray:
        """(2E, 2) directed edge list (src, dst) — both directions present."""
        src = np.repeat(np.arange(self.n, dtype=np.int32), self.degrees)
        return np.stack([src, self.indices.astype(np.int32)], axis=1)

    @staticmethod
    def from_edges(n: int, edges: np.ndarray) -> "Graph":
        """Build from an (E, 2) array of undirected edges (any order/dups)."""
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        # drop self loops, symmetrize, dedup
        edges = edges[edges[:, 0] != edges[:, 1]]
        both = np.concatenate([edges, edges[:, ::-1]], axis=0)
        key = both[:, 0] * n + both[:, 1]
        _, uniq = np.unique(key, return_index=True)
        both = both[uniq]
        order = np.lexsort((both[:, 1], both[:, 0]))
        both = both[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, both[:, 0] + 1, 1)
        indptr = np.cumsum(indptr)
        return Graph(n=n, indptr=indptr, indices=both[:, 1].astype(np.int32))


@dataclass
class PartitionedGraph:
    """Device-partitioned graph, padded for SPMD.

    All per-device arrays carry a leading ``ndev`` axis so they can be fed to
    ``shard_map`` sharded on that axis. Vertices are *globally renumbered* so
    that device t owns the contiguous id range [t*stride, t*stride + n_local[t])
    — the ownership map is then ``owner(v) = v // stride`` (one integer, even
    cheaper than the paper's one-byte-per-vertex map) and local index is
    ``v - t*stride``. ``old2new``/``new2old`` translate to original ids.
    """

    n: int                 # number of (renumbered) global vertices = ndev*stride
    n_real: int            # actual vertex count (n_real <= n; rest are padding)
    ndev: int
    stride: int            # owned id-range width per device
    max_degree: int
    adj: np.ndarray        # (ndev, stride, max_degree) int32, sentinel = n
    deg: np.ndarray        # (ndev, stride) int32
    n_local: np.ndarray    # (ndev,) int32 — real vertices per device
    border: np.ndarray     # (ndev, stride) bool — has a foreign neighbor
    border_dist: np.ndarray  # (ndev, stride) int32 — hops to nearest border vertex
    old2new: np.ndarray    # (n_real,) int32
    new2old: np.ndarray    # (n,) int32 (padding rows = -1)

    @property
    def sentinel(self) -> int:
        return self.n

    def owner(self, v: np.ndarray | int):
        return v // self.stride

    def global_deg(self) -> np.ndarray:
        return self.deg.reshape(-1)

    def neighbors(self, v: int) -> np.ndarray:
        t, i = divmod(int(v), self.stride)
        return self.adj[t, i, : self.deg[t, i]]

    def has_edge(self, u: int, v: int) -> bool:
        row = self.neighbors(u)
        j = np.searchsorted(row, v)
        return bool(j < row.shape[0] and row[j] == v)

    def to_device(self, fmt: str = "dense", device=None) -> "DeviceGraph":
        """Export this partition in a registered on-device format."""
        return device_graph(self, fmt, device)


def build_partitioned(graph: Graph, ndev: int, assignment: np.ndarray,
                      max_degree: int | None = None) -> PartitionedGraph:
    """Partition ``graph`` given a per-vertex device ``assignment`` (n,).

    Renumbers vertices device-contiguously, builds padded adjacency, border
    flags and the border-distance map (multi-source BFS inside each local
    subgraph — Definition 1).
    """
    n = graph.n
    assignment = np.asarray(assignment, dtype=np.int32)
    counts = np.bincount(assignment, minlength=ndev)
    stride = int(counts.max()) if n else 1
    stride = max(stride, 1)

    # renumber: vertices of device t -> [t*stride, t*stride+counts[t])
    order = np.argsort(assignment, kind="stable")
    old2new = np.empty(n, dtype=np.int32)
    offs = np.zeros(ndev + 1, dtype=np.int64)
    offs[1:] = np.cumsum(counts)
    for t in range(ndev):
        vs = order[offs[t]:offs[t + 1]]
        old2new[vs] = t * stride + np.arange(len(vs), dtype=np.int32)
    n_new = ndev * stride
    new2old = np.full(n_new, -1, dtype=np.int32)
    new2old[old2new] = np.arange(n, dtype=np.int32)

    md = max_degree if max_degree is not None else max(graph.max_degree, 1)
    adj = np.full((ndev, stride, md), n_new, dtype=np.int32)
    deg = np.zeros((ndev, stride), dtype=np.int32)
    border = np.zeros((ndev, stride), dtype=bool)

    for old_v in range(n):
        nv = int(old2new[old_v])
        t, i = divmod(nv, stride)
        nbrs = np.sort(old2new[graph.neighbors(old_v)]).astype(np.int32)
        d = len(nbrs)
        if d > md:
            raise ValueError(f"vertex degree {d} exceeds max_degree {md}")
        adj[t, i, :d] = nbrs
        deg[t, i] = d
        if d and (np.any(nbrs // stride != t)):
            border[t, i] = True

    border_dist = _border_distance(adj, deg, border, stride, n_new)
    return PartitionedGraph(
        n=n_new, n_real=n, ndev=ndev, stride=stride, max_degree=md,
        adj=adj, deg=deg, n_local=counts.astype(np.int32), border=border,
        border_dist=border_dist, old2new=old2new, new2old=new2old)


def _border_distance(adj: np.ndarray, deg: np.ndarray, border: np.ndarray,
                     stride: int, n_new: int) -> np.ndarray:
    """Multi-source BFS from border vertices over *local* edges (Def. 1).

    Non-border components with no border vertex get distance INF (2**30) —
    their seeds are always SM-E eligible.
    """
    ndev = adj.shape[0]
    INF = np.int32(1 << 30)
    out = np.full((ndev, stride), INF, dtype=np.int32)
    for t in range(ndev):
        dist = out[t]
        frontier = np.flatnonzero(border[t])
        dist[frontier] = 0
        d = 0
        while frontier.size:
            d += 1
            nxt = []
            for i in frontier:
                nbrs = adj[t, i, : deg[t, i]]
                local = nbrs[(nbrs // stride) == t] - t * stride
                fresh = local[dist[local] > d]
                dist[fresh] = d
                nxt.append(fresh)
            frontier = np.unique(np.concatenate(nxt)) if nxt else np.array([], np.int64)
    return out


# --------------------------------------------------------------------------- #
# DeviceGraph: on-device adjacency in the stacked (ndev, ...) layout
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class DeviceGraph:
    """Abstract on-device adjacency in the stacked ``(ndev, ...)`` layout.

    For local indices ``li`` of shape ``(d, ...)`` — device ``t0 + i``'s
    entries in ``li[i]``, each in ``[0, stride)`` — with ``d`` devices
    starting at ``t0``:

    * ``rows_at(li, t0)`` -> ``(d, ..., max_degree)`` int32 adjacency
      windows — sorted neighbor ids then sentinel ``n`` padding;
    * ``deg_at(li, t0)``  -> ``(d, ...)`` int32 degrees.
    """

    format: ClassVar[str] = "abstract"

    ndev: int
    stride: int
    n: int            # sentinel == n
    max_degree: int

    def rows_at(self, li: torch.Tensor, t0: int = 0) -> torch.Tensor:
        raise NotImplementedError

    def deg_at(self, li: torch.Tensor, t0: int = 0) -> torch.Tensor:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    @property
    def adj_bytes(self) -> int:
        raise NotImplementedError


def _dev_index(li: torch.Tensor, t0: int) -> torch.Tensor:
    """Device ids ``t0..t0+d-1`` shaped ``(d, 1, ...)`` to pair with local
    indices ``li (d, ...)`` in one advanced index: the index kernel
    broadcasts the two, so no full-size flat index is built."""
    t = torch.arange(t0, t0 + li.shape[0], device=li.device)
    return t.view((-1,) + (1,) * (li.dim() - 1))


@dataclass(frozen=True)
class DenseDeviceGraph(DeviceGraph):
    """The reference layout: ``adj[dev, local_v, :max_degree]``
    (O(n_local × d_max) memory, one gather per row)."""

    format: ClassVar[str] = "dense"

    adj: torch.Tensor   # (ndev, stride, max_degree) int32, sentinel = n
    deg: torch.Tensor   # (ndev, stride) int32

    @classmethod
    def from_partitioned(cls, pg: PartitionedGraph,
                         device=None) -> "DenseDeviceGraph":
        device = resolve_device(device)
        return cls(ndev=pg.ndev, stride=pg.stride, n=pg.n,
                   max_degree=pg.max_degree,
                   adj=torch.as_tensor(pg.adj, device=device),
                   deg=torch.as_tensor(pg.deg, device=device))

    @property
    def device(self) -> torch.device:
        return self.adj.device

    @property
    def adj_bytes(self) -> int:
        """Resident device adjacency footprint."""
        return int(sum(x.numel() * x.element_size()
                       for x in (self.adj, self.deg)))

    def rows_at(self, li, t0=0):
        li = li.contiguous()          # the result takes the index's layout
        return self.adj[_dev_index(li, t0), li]

    def deg_at(self, li, t0=0):
        li = li.contiguous()
        return self.deg[_dev_index(li, t0), li]


def device_graph(pg: PartitionedGraph, fmt: str = "dense",
                 device=None) -> DeviceGraph:
    """Export ``pg`` in the on-device format ``fmt`` (``dense`` only in
    this slice of the port)."""
    if fmt == "bucketed":
        raise NotImplementedError(
            "storage_format='bucketed' is not ported yet "
            "(ROADMAP queue A item 6)")
    if fmt != "dense":
        raise ValueError(f"unknown storage format {fmt!r}; expected 'dense'")
    return DenseDeviceGraph.from_partitioned(pg, device)
