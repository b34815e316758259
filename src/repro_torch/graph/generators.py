"""Synthetic graph generators — stand-ins for the paper's datasets
(RoadNet / DBLP / LiveJournal / UK2002) plus the reference package's other
generators (community graphs, molecule batches, GraphCast's icosahedral
multi-mesh), copied so the port needs nothing of the reference.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.storage import Graph


def road_graph(n: int = 4096, seed: int = 0) -> Graph:
    """RoadNet stand-in: sqrt(n) x sqrt(n) lattice with a few shortcuts.

    Avg degree ~2-4 and diameter O(sqrt(n)) — like a road network, most
    vertices sit far from any partition border (SM-E heaven).
    """
    side = int(np.sqrt(n))
    n = side * side
    rng = np.random.default_rng(seed)
    idx = np.arange(n).reshape(side, side)
    e = []
    e.append(np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1))
    e.append(np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1))
    # sparse shortcuts (bridges/ramps): 1% of n
    k = max(n // 100, 1)
    extra = rng.integers(0, n, size=(k, 2))
    edges = np.concatenate(e + [extra], axis=0)
    return Graph.from_edges(n, edges)


def powerlaw_graph(n: int, avg_deg: int, seed: int = 0) -> Graph:
    """Barabasi-Albert-style preferential attachment (social/web stand-in).

    Draws the same random stream as the reference generator, which
    rebuilds its endpoint pool as a fresh array for every vertex (O(n²)).
    Here the pool is one preallocated buffer filled in place, and
    ``rng.integers(0, k, size=m)`` indexes its first ``k`` entries — what
    ``Generator.choice(pool, m, replace=True)`` draws — so the CSR is
    bit-identical in O(n·m).
    """
    m = max(avg_deg // 2, 1)
    rng = np.random.default_rng(seed)
    pool = np.empty(m + 2 * m * max(n - m, 0), dtype=np.int64)
    pool[:m] = np.arange(m)           # initial clique-ish core
    k = m
    src: list[int] = []
    dst: list[int] = []
    for v in range(m, n):
        # preferential: sample from the repeated-endpoint pool
        tg = np.unique(pool[rng.integers(0, k, size=m)])
        src.extend([v] * len(tg))
        dst.extend(tg.tolist())
        pool[k:k + 2 * len(tg):2] = tg
        pool[k + 1:k + 2 * len(tg):2] = v
        k += 2 * len(tg)
    edges = np.stack([np.array(src, dtype=np.int64),
                      np.array(dst, dtype=np.int64)], axis=1)
    return Graph.from_edges(n, edges)


def erdos_graph(n: int, avg_deg: float, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    n_edges = int(n * avg_deg / 2)
    edges = rng.integers(0, n, size=(n_edges, 2))
    return Graph.from_edges(n, edges)


def community_graph(n: int, n_comm: int, p_in_deg: float, p_out_deg: float,
                    seed: int = 0) -> Graph:
    """DBLP-like: dense communities + sparse cross edges."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_comm, size=n)
    edges = []
    n_in = int(n * p_in_deg / 2)
    order = np.argsort(comm)
    bounds = np.searchsorted(comm[order], np.arange(n_comm + 1))
    for c in range(n_comm):
        mem = order[bounds[c]:bounds[c + 1]]
        if len(mem) < 2:
            continue
        k = max(int(len(mem) * p_in_deg / 2), 1)
        e = rng.choice(mem, size=(k, 2))
        edges.append(e)
    k_out = max(int(n * p_out_deg / 2), 1)
    edges.append(rng.integers(0, n, size=(k_out, 2)))
    return Graph.from_edges(n, np.concatenate(edges))


def molecule_batch(batch: int, n_nodes: int = 30, n_edges: int = 64,
                   seed: int = 0) -> Graph:
    """``batch`` disjoint small molecules packed in one graph (batched-small)."""
    rng = np.random.default_rng(seed)
    edges = []
    for b in range(batch):
        base = b * n_nodes
        # random spanning chain + extra bonds, degree <= 4 (chemistry-ish)
        chain = np.stack([np.arange(n_nodes - 1), np.arange(1, n_nodes)], 1)
        extra = rng.integers(0, n_nodes, size=(max(n_edges // 2 - (n_nodes - 1), 0), 2))
        e = np.concatenate([chain, extra]) + base
        edges.append(e)
    return Graph.from_edges(batch * n_nodes, np.concatenate(edges))


def icosahedral_mesh(refinement: int) -> tuple[np.ndarray, np.ndarray]:
    """GraphCast multi-mesh: icosahedron refined ``refinement`` times.

    Returns (vertices (V,3) float32 on unit sphere, multi-mesh undirected
    edge list (E,2) — union of edges of *all* refinement levels, as in
    GraphCast).
    """
    phi = (1 + np.sqrt(5)) / 2
    verts = np.array(
        [(-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
         (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
         (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1)],
        dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)],
        dtype=np.int64)

    def face_edges(fs):
        e = np.concatenate([fs[:, [0, 1]], fs[:, [1, 2]], fs[:, [2, 0]]])
        return e

    all_edges = [face_edges(faces)]
    vlist = [verts]
    cache: dict[tuple[int, int], int] = {}

    def midpoint(a: int, b: int) -> int:
        key = (min(a, b), max(a, b))
        if key in cache:
            return cache[key]
        m = vlist[0][a] + vlist[0][b]
        m /= np.linalg.norm(m)
        vlist[0] = np.concatenate([vlist[0], m[None]], axis=0)
        cache[key] = len(vlist[0]) - 1
        return cache[key]

    for _ in range(refinement):
        new_faces = []
        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = np.array(new_faces, dtype=np.int64)
        all_edges.append(face_edges(faces))

    edges = np.unique(np.sort(np.concatenate(all_edges), axis=1), axis=0)
    return vlist[0].astype(np.float32), edges


def make_dataset(kind: str, **kw) -> Graph:
    if kind == "road":
        return road_graph(**kw)
    if kind == "powerlaw":
        return powerlaw_graph(**kw)
    if kind == "erdos":
        return erdos_graph(**kw)
    if kind == "community":
        return community_graph(**kw)
    if kind == "molecule":
        return molecule_batch(**kw)
    raise KeyError(kind)


def load_dataset(name: str) -> Graph:
    from repro_torch.configs.rads import DATASETS
    spec = dict(DATASETS[name])
    return make_dataset(spec.pop("kind"), **spec)
