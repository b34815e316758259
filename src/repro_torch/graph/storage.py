"""Graph storage: host-side CSR, device partitioning, and the on-device
adjacency (:class:`DeviceGraph`).

The host half (:class:`Graph`, :class:`PartitionedGraph`,
:func:`build_partitioned`) is a copy of the reference package's numpy
code: an undirected, unlabeled data graph in CSR form with sorted rows,
renumbered device-contiguously so ``owner(v) = v // stride``.

On the card the engine reads adjacency only through :class:`DeviceGraph`:
``rows_at``/``deg_at`` over the stacked layout, returning sentinel
``n``-padded rows of width ``max_degree``.  A device graph holds a block
of the machines, ``dev0 .. dev0 + nloc - 1`` of ``ndev`` (all of them
under the ``sim`` and ``gather`` exchanges, the rank's own under
``spmd``/``dist``: the reference's ``g.shard(mesh)``), and every accessor
takes per-machine local indices with a leading ``nloc`` axis — the batch
dimension that replaces the reference's ``jax.vmap`` over devices.  Two
formats: ``dense`` (the padded reference layout) and ``bucketed``
(degree-bucketed slabs, whose windows are byte-identical to the dense
ones).
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

    def to_device(self, fmt: str = "dense", device=None,
                  block: tuple[int, int] | None = None) -> "DeviceGraph":
        """Export this partition (or the machines ``block = (dev0, nloc)``
        of it) in a registered on-device format."""
        return device_graph(self, fmt, device, block)


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
    """Abstract on-device adjacency of the machines ``dev0 .. dev0 + nloc
    - 1`` in the stacked ``(nloc, ...)`` layout.

    For local indices ``li`` of shape ``(d, ...)`` — machine ``t0 + i``'s
    entries in ``li[i]``, each in ``[0, stride)`` — with ``d`` machines
    starting at the *global* machine id ``t0`` (inside the block):

    * ``rows_at(li, t0)`` -> ``(d, ..., max_degree)`` int32 adjacency
      windows — sorted neighbor ids then sentinel ``n`` padding;
    * ``deg_at(li, t0)``  -> ``(d, ...)`` int32 degrees.

    ``ndev``, ``stride`` and ``n`` stay global.  ``adj_bytes`` is the
    whole stack's footprint, as the reference reports it for a sharded
    graph; ``resident_bytes`` is what this block holds.
    """

    format: ClassVar[str] = "abstract"
    # back-edge candidate refinement: False routes through the membership
    # kernel, True through the sorted-window intersect kernel (Alg. 1
    # line 6), as the reference's formats choose
    intersect_backedge: ClassVar[bool] = False

    ndev: int
    stride: int
    n: int            # sentinel == n
    max_degree: int
    dev0: int         # first machine of the block held here
    nloc: int         # machines in the block

    def rows_at(self, li: torch.Tensor, t0: int = 0) -> torch.Tensor:
        raise NotImplementedError

    def deg_at(self, li: torch.Tensor, t0: int = 0) -> torch.Tensor:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    @property
    def resident_bytes(self) -> int:
        """Device adjacency footprint of this block."""
        raise NotImplementedError

    @property
    def adj_bytes(self) -> int:
        """Device adjacency footprint of the whole stack: every block has
        the same shapes."""
        return self.resident_bytes * self.ndev // self.nloc

    def _dev_index(self, li: torch.Tensor, t0: int) -> torch.Tensor:
        """Block rows of the machines ``t0..t0+d-1`` shaped ``(d, 1,
        ...)`` to pair with local indices ``li (d, ...)`` in one advanced
        index: the index kernel broadcasts the two, so no full-size flat
        index is built."""
        t = torch.arange(t0 - self.dev0, t0 - self.dev0 + li.shape[0],
                         device=li.device)
        return t.view((-1,) + (1,) * (li.dim() - 1))


def _block(pg: PartitionedGraph, block) -> tuple[int, int]:
    dev0, nloc = (0, pg.ndev) if block is None else block
    if not (0 <= dev0 and nloc >= 1 and dev0 + nloc <= pg.ndev):
        raise ValueError(f"block {block} is not inside {pg.ndev} machines")
    return dev0, nloc


@dataclass(frozen=True)
class DenseDeviceGraph(DeviceGraph):
    """The reference layout: ``adj[dev, local_v, :max_degree]``
    (O(n_local × d_max) memory, one gather per row)."""

    format: ClassVar[str] = "dense"

    adj: torch.Tensor   # (ndev, stride, max_degree) int32, sentinel = n
    deg: torch.Tensor   # (ndev, stride) int32

    @classmethod
    def from_partitioned(cls, pg: PartitionedGraph, device=None,
                         block=None) -> "DenseDeviceGraph":
        device = resolve_device(device)
        dev0, nloc = _block(pg, block)
        part = slice(dev0, dev0 + nloc)
        return cls(ndev=pg.ndev, stride=pg.stride, n=pg.n,
                   max_degree=pg.max_degree, dev0=dev0, nloc=nloc,
                   adj=torch.as_tensor(pg.adj[part], device=device),
                   deg=torch.as_tensor(pg.deg[part], device=device))

    @property
    def device(self) -> torch.device:
        return self.adj.device

    @property
    def resident_bytes(self) -> int:
        return int(sum(x.numel() * x.element_size()
                       for x in (self.adj, self.deg)))

    def rows_at(self, li, t0=0):
        li = li.contiguous()          # the result takes the index's layout
        return self.adj[self._dev_index(li, t0), li]

    def deg_at(self, li, t0=0):
        li = li.contiguous()
        return self.deg[self._dev_index(li, t0), li]


@dataclass(frozen=True)
class BucketedDeviceGraph(DeviceGraph):
    """Degree-bucketed padded CSR slabs (the reference's ``bucketed``
    format, ``src/repro/graph/storage.py``).

    Vertices with ``deg > 0`` are grouped into power-of-two degree buckets
    (cap 1, 2, 4, ... — the top cap clamped to ``max_degree``); bucket
    ``b`` holds one slab ``(ndev, n_b_max, cap_b)`` padded only to its own
    cap, plus the per-vertex ``bucket_of``/``slot_of`` maps.  Adjacency
    memory is ~O(Σ_b n_b · cap_b) instead of the dense O(n · d_max).

    The slabs lie end to end in one flat buffer per device, in ascending
    cap order (:attr:`slabs` gives the per-bucket views).  A window is then
    one gather of ``max_degree`` ids starting at ``base[b] + slot · cap[b]``
    — through an overlapping strided view of the buffer, so no per-element
    index is built — masked by ``col < deg``.  The reference reassembles a
    window with one full-width select per bucket instead; both give the
    dense format's windows byte for byte.  Ids past a row's own cap belong
    to the next rows and are masked; the buffer carries ``max(0,
    max_degree - top cap)`` ids of tail per device so that the last window
    stays inside it (none unless ``max_degree`` was padded above the real
    maximum).  ``base``/``caps`` are the device copy of the static bucket
    table and, like the reference's ``bucket_caps``, are not counted in
    :attr:`adj_bytes`.  The bucket table (caps and slab rows) is the whole
    stack's, so a block's slabs are laid out as in the full graph."""

    format: ClassVar[str] = "bucketed"
    intersect_backedge: ClassVar[bool] = True

    bucket_caps: tuple       # padded row width per bucket, ascending
    bucket_rows: tuple       # n_b_max: slab rows per bucket
    deg: torch.Tensor        # (ndev, stride) int32
    bucket_of: torch.Tensor  # (ndev, stride) int32 (0 where deg == 0)
    slot_of: torch.Tensor    # (ndev, stride) int32 (0 where deg == 0)
    flat: torch.Tensor       # (ndev, Σ_b n_b_max·cap_b + tail) int32
    base: torch.Tensor       # (n_buckets,) int32 offset of each slab
    caps: torch.Tensor       # (n_buckets,) int32 == bucket_caps

    @classmethod
    def from_partitioned(cls, pg: PartitionedGraph, device=None,
                         block=None) -> "BucketedDeviceGraph":
        device = resolve_device(device)
        dev0, nloc = _block(pg, block)
        ndev, stride, n, D = pg.ndev, pg.stride, pg.n, pg.max_degree
        deg = np.asarray(pg.deg, dtype=np.int32)
        real_max = int(deg.max()) if deg.size else 0
        caps: list[int] = []
        c = 1
        while c < max(real_max, 1):
            caps.append(c)
            c *= 2
        caps.append(min(c, D) if real_max else 1)
        caps_arr = np.asarray(caps, dtype=np.int32)

        bucket_of = np.zeros((ndev, stride), dtype=np.int32)
        slot_of = np.zeros((ndev, stride), dtype=np.int32)
        has_row = deg > 0
        bucket_of[has_row] = np.searchsorted(caps_arr, deg[has_row])
        members = [[np.flatnonzero(has_row[t] & (bucket_of[t] == b))
                    for b in range(len(caps))] for t in range(ndev)]
        for t in range(ndev):
            for b in range(len(caps)):
                slot_of[t, members[t][b]] = np.arange(len(members[t][b]),
                                                      dtype=np.int32)
        rows = [max(max(len(members[t][b]) for t in range(ndev)), 1)
                for b in range(len(caps))]
        sizes = [r * cap for r, cap in zip(rows, caps)]
        base = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
        flat = np.full((nloc, sum(sizes) + max(0, D - caps[-1])), n,
                       dtype=np.int32)
        for i in range(nloc):
            for b, cap in enumerate(caps):
                m = members[dev0 + i][b]
                if len(m):
                    flat[i, base[b]:base[b] + len(m) * cap] = \
                        pg.adj[dev0 + i, m, :cap].reshape(-1)
        part = slice(dev0, dev0 + nloc)
        as_t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
        return cls(ndev=ndev, stride=stride, n=n, max_degree=D, dev0=dev0,
                   nloc=nloc, bucket_caps=tuple(caps),
                   bucket_rows=tuple(rows), deg=as_t(deg[part]),
                   bucket_of=as_t(bucket_of[part]),
                   slot_of=as_t(slot_of[part]), flat=as_t(flat),
                   base=as_t(base), caps=as_t(caps_arr))

    @property
    def device(self) -> torch.device:
        return self.flat.device

    @property
    def resident_bytes(self) -> int:
        """The slabs and the three per-vertex maps."""
        return int(sum(x.numel() * x.element_size()
                       for x in (self.deg, self.bucket_of, self.slot_of,
                                 self.flat)))

    @property
    def slabs(self) -> tuple:
        """Per bucket, the ``(nloc, n_b_max, cap_b)`` view of its slab."""
        out = []
        for b0, r, cap in zip(self.base.tolist(), self.bucket_rows,
                              self.bucket_caps):
            out.append(self.flat[:, b0:b0 + r * cap].view(self.nloc, r, cap))
        return tuple(out)

    def rows_at(self, li, t0=0):
        li = li.contiguous()
        dv = self._dev_index(li, t0)
        b = self.bucket_of[dv, li]
        start = self.base[b] + self.slot_of[dv, li] * self.caps[b]
        D = self.max_degree
        # windows[t, s] = flat[t, s:s + D], overlapping, never written
        windows = self.flat.as_strided(
            (self.nloc, self.flat.shape[1] - D + 1, D),
            (self.flat.shape[1], 1, 1))
        out = windows[dv, start]
        col = torch.arange(D, dtype=torch.int32, device=li.device)
        return out.masked_fill_(col >= self.deg[dv, li][..., None], self.n)

    def deg_at(self, li, t0=0):
        li = li.contiguous()
        return self.deg[self._dev_index(li, t0), li]


FORMATS = {"dense": DenseDeviceGraph, "bucketed": BucketedDeviceGraph}


def device_graph(pg: PartitionedGraph, fmt: str = "dense",
                 device=None, block: tuple[int, int] | None = None
                 ) -> DeviceGraph:
    """Export ``pg`` in the on-device format ``fmt``: every machine, or
    only the machines ``block = (dev0, nloc)`` (a rank's own under
    ``spmd``/``dist``; nothing else is uploaded)."""
    try:
        cls = FORMATS[fmt]
    except KeyError:
        raise ValueError(f"unknown storage format {fmt!r}; expected one of "
                         f"{sorted(FORMATS)}") from None
    return cls.from_partitioned(pg, device, block)
