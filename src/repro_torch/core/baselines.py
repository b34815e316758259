"""Baselines the paper compares against (§7, §8) — vectorized numpy
implementations with explicit communication/memory accounting.

* ``psgl_enumerate``     — PSgL [21]: Pregel-style one-vertex-per-round
  expansion; partial matches are *shuffled* to the owner of the candidate
  vertex each round (the paper's critique: intermediate results on the
  wire, no compression, no memory control).
* ``join_enumerate``     — TwinTwig [13] / SEED [15]: star decomposition
  units + multi-round hash joins; *both* join sides are shuffled by join
  key every round.
* ``crystal_lite``       — Crystal [18]: clique-index based; we build the
  triangle index (the dominant index in their design) and seed matching
  from it, reporting index bytes (Table 2 analogue).

These are algorithmic reproductions for the paper's comparison tables
(Figures 8-11): the quantities compared — shuffled bytes, peak intermediate
rows, result counts — are implementation-independent; wall times are
comparable across baselines (all share the same vectorization style) but
not against the RADS engine (different runtime), see EXPERIMENTS.md.  A
copy of the reference's ``core/baselines.py`` over the port's
``PartitionedGraph`` and ``Pattern``: pure numpy on the host, with no
device path; the same inputs give the same counts, embeddings and bytes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.query import Pattern
from repro_torch.graph.storage import Graph, PartitionedGraph


@dataclass
class BaselineResult:
    count: int
    embeddings: set[tuple[int, ...]] | None
    bytes_shuffled: float
    peak_rows: int
    seconds: float
    extra: dict = field(default_factory=dict)


# --------------------------------------------------------------------------- #
# shared vectorized helpers (numpy, padded-adjacency style)
# --------------------------------------------------------------------------- #
def _adj_rows(pg: PartitionedGraph, v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Padded adjacency rows + degrees for global (renumbered) ids v."""
    own = v // pg.stride
    loc = v - own * pg.stride
    return pg.adj[own, loc], pg.deg[own, loc]


def _member(pg: PartitionedGraph, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Edge-existence test (u, v) elementwise (global renumbered ids)."""
    rows, _ = _adj_rows(pg, u)
    return (rows == v[:, None]).any(axis=1)


def _expand(pg: PartitionedGraph, rows: np.ndarray, anchor_col: int,
            leaf_deg: int, back_cols: list[int], lt_cols: list[int],
            gt_cols: list[int]) -> np.ndarray:
    """All extensions of ``rows`` by one vertex from adj(rows[:, anchor]),
    with injectivity / degree / symmetry / back-edge checks."""
    k, w = rows.shape
    arow, adeg = _adj_rows(pg, rows[:, anchor_col])
    D = arow.shape[1]
    cand = arow.reshape(-1)
    parent = np.repeat(np.arange(k), D)
    valid = cand < pg.n
    for c in range(w):
        valid &= cand != rows[parent, c]
    for c in lt_cols:
        valid &= rows[parent, c] < cand
    for c in gt_cols:
        valid &= cand < rows[parent, c]
    cand_c = np.where(valid, cand, 0)
    _, cdeg = _adj_rows(pg, cand_c)
    valid &= cdeg >= leaf_deg
    for c in back_cols:
        chk = _member(pg, cand_c, rows[parent, c])
        valid &= chk
    parent, cand = parent[valid], cand[valid]
    return np.column_stack([rows[parent], cand]).astype(np.int64)


def _order_and_filters(pattern: Pattern):
    """BFS matching order + per-step anchor/back/symmetry column lists."""
    order = [0]
    seen = {0}
    i = 0
    while len(order) < pattern.n:
        u = order[i]
        i += 1
        for wv in pattern.adj(u):
            if wv not in seen:
                seen.add(wv)
                order.append(wv)
    pos = {u: j for j, u in enumerate(order)}
    cons = pattern.symmetry_constraints()
    steps = []
    for j in range(1, pattern.n):
        u = order[j]
        back = [pos[wv] for wv in pattern.adj(u) if pos[wv] < j]
        anchor = back[0]
        back = back[1:]
        lt = [pos[a] for (a, b) in cons if b == u and pos[a] < j]
        gt = [pos[b] for (a, b) in cons if a == u and pos[b] < j]
        steps.append((pos[u], anchor, back, lt, gt, pattern.degree(u)))
    return order, steps


def _to_query_order(rows: np.ndarray, order: list[int],
                    pg: PartitionedGraph) -> set[tuple[int, ...]]:
    inv = np.argsort(np.array(order))
    out = set()
    for r in pg.new2old[rows][:, inv]:
        out.add(tuple(int(x) for x in r))
    return out


# --------------------------------------------------------------------------- #
# PSgL
# --------------------------------------------------------------------------- #
def psgl_enumerate(pg: PartitionedGraph, pattern: Pattern,
                   return_embeddings: bool = True) -> BaselineResult:
    t0 = time.perf_counter()
    order, steps = _order_and_filters(pattern)
    # round 0: all local candidates of order[0]
    deg0 = pattern.degree(order[0])
    all_v = np.flatnonzero(pg.new2old >= 0)
    degs = pg.deg.reshape(-1)[all_v]
    rows = all_v[degs >= deg0][:, None].astype(np.int64)
    loc = rows[:, 0] // pg.stride                 # current machine of partials
    bytes_shuffled = 0.0
    peak = rows.shape[0]
    for (col, anchor, back, lt, gt, ldeg) in steps:
        # shuffle partials to owner(f(anchor)) — PSgL routes the partial
        # match to the worker holding the expansion vertex
        tgt = rows[:, anchor] // pg.stride
        moved = tgt != loc
        bytes_shuffled += float(moved.sum()) * rows.shape[1] * 4
        loc = tgt
        rows = _expand(pg, rows, anchor, ldeg, back, lt, gt)
        # new partial lives at owner(candidate) for the *next* verify step
        loc = rows[:, -1] // pg.stride if rows.size else np.zeros(0, np.int64)
        peak = max(peak, rows.shape[0])
    secs = time.perf_counter() - t0
    embs = _to_query_order(rows, order, pg) if return_embeddings else None
    return BaselineResult(count=rows.shape[0], embeddings=embs,
                          bytes_shuffled=bytes_shuffled, peak_rows=peak,
                          seconds=secs)


# --------------------------------------------------------------------------- #
# TwinTwig / SEED (join-based)
# --------------------------------------------------------------------------- #
def star_decomposition(pattern: Pattern, max_edges: int) -> list[tuple[int, tuple[int, ...]]]:
    """Partition E_P into stars (center, leaves); TwinTwig caps stars at 2
    edges, SEED does not."""
    remaining = set(pattern.edges)
    units: list[tuple[int, tuple[int, ...]]] = []
    while remaining:
        # pick the vertex with most remaining incident edges
        cnt: dict[int, int] = {}
        for (a, b) in remaining:
            cnt[a] = cnt.get(a, 0) + 1
            cnt[b] = cnt.get(b, 0) + 1
        c = max(cnt, key=lambda x: (cnt[x], -x))
        leaves = [b if a == c else a for (a, b) in remaining if c in (a, b)]
        leaves = tuple(sorted(leaves)[:max_edges])
        units.append((c, leaves))
        for lf in leaves:
            remaining.discard((min(c, lf), max(c, lf)))
    # order units so each shares a vertex with the prefix (join-ability)
    ordered = [units[0]]
    rest = units[1:]
    covered = {units[0][0], *units[0][1]}
    while rest:
        for i, (c, lf) in enumerate(rest):
            if c in covered or any(x in covered for x in lf):
                ordered.append(rest.pop(i))
                covered.update({c, *lf})
                break
        else:  # disconnected remainder (cannot happen for connected P)
            ordered.append(rest.pop(0))
            covered.update({ordered[-1][0], *ordered[-1][1]})
    return ordered


def _star_embeddings(pg: PartitionedGraph, pattern: Pattern,
                     unit: tuple[int, tuple[int, ...]]) -> np.ndarray:
    """All embeddings of one star unit (computed locally on each machine —
    a star centered at v needs only adj(v))."""
    c, leaves = unit
    all_v = np.flatnonzero(pg.new2old >= 0)
    degs = pg.deg.reshape(-1)[all_v]
    rows = all_v[degs >= pattern.degree(c)][:, None].astype(np.int64)
    for j, lf in enumerate(leaves):
        k = rows.shape[0]
        arow, _ = _adj_rows(pg, rows[:, 0])
        D = arow.shape[1]
        cand = arow.reshape(-1)
        parent = np.repeat(np.arange(k), D)
        valid = cand < pg.n
        for cc in range(rows.shape[1]):
            valid &= cand != rows[parent, cc]
        cand_c = np.where(valid, cand, 0)
        _, cdeg = _adj_rows(pg, cand_c)
        valid &= cdeg >= pattern.degree(lf)
        rows = np.column_stack([rows[parent[valid]], cand[valid]])
    return rows  # columns: [center, *leaves]


def join_enumerate(pg: PartitionedGraph, pattern: Pattern,
                   kind: str = "twintwig",
                   return_embeddings: bool = True) -> BaselineResult:
    t0 = time.perf_counter()
    max_edges = 2 if kind == "twintwig" else pattern.n
    units = star_decomposition(pattern, max_edges)
    cons = pattern.symmetry_constraints()
    bytes_shuffled = 0.0
    peak = 0

    part_cols: list[int] = []          # query vertices covered so far
    part: np.ndarray | None = None
    for (c, leaves) in units:
        unit_rows = _star_embeddings(pg, pattern, (c, leaves))
        unit_cols = [c, *leaves]
        peak = max(peak, unit_rows.shape[0])
        if part is None:
            part, part_cols = unit_rows, unit_cols
        else:
            shared = [u for u in unit_cols if u in part_cols]
            newv = [u for u in unit_cols if u not in part_cols]
            # MapReduce-style shuffle of BOTH sides by join key
            bytes_shuffled += (part.size + unit_rows.size) * 4 * \
                (1 - 1 / pg.ndev)
            key_p = _key(part, [part_cols.index(u) for u in shared], pg.n)
            key_u = _key(unit_rows, [unit_cols.index(u) for u in shared], pg.n)
            op, ou = np.argsort(key_p, kind="stable"), np.argsort(key_u, kind="stable")
            part, key_p = part[op], key_p[op]
            unit_rows, key_u = unit_rows[ou], key_u[ou]
            lo = np.searchsorted(key_u, key_p, side="left")
            hi = np.searchsorted(key_u, key_p, side="right")
            cnt = hi - lo
            pi = np.repeat(np.arange(part.shape[0]), cnt)
            ui = _range_concat(lo, cnt)
            new_cols_idx = [unit_cols.index(u) for u in newv]
            joined = np.column_stack([part[pi], unit_rows[ui][:, new_cols_idx]])
            # injectivity across the new columns
            valid = np.ones(joined.shape[0], dtype=bool)
            base_w = part.shape[1]
            for j in range(len(newv)):
                for cc in range(base_w + j):
                    valid &= joined[:, base_w + j] != joined[:, cc]
            part = joined[valid]
            part_cols = part_cols + newv
        # early symmetry filtering where both endpoints are covered
        part = _apply_sym(part, part_cols, cons)
        peak = max(peak, part.shape[0])
    # verify edges not inside any star: both endpoints covered at the end
    covered_pairs = set()
    for (c, leaves) in units:
        for lf in leaves:
            covered_pairs.add((min(c, lf), max(c, lf)))
    missing = [e for e in pattern.edges if e not in covered_pairs]
    for (a, b) in missing:
        ia, ib = part_cols.index(a), part_cols.index(b)
        part = part[_member(pg, part[:, ia], part[:, ib])]
    secs = time.perf_counter() - t0
    embs = _to_query_order(part, part_cols, pg) if return_embeddings else None
    return BaselineResult(count=part.shape[0], embeddings=embs,
                          bytes_shuffled=bytes_shuffled, peak_rows=peak,
                          seconds=secs, extra=dict(n_units=len(units)))


def _key(rows: np.ndarray, cols: list[int], n: int) -> np.ndarray:
    k = np.zeros(rows.shape[0], dtype=np.int64)
    for c in cols:
        k = k * n + rows[:, c]
    return k


def _range_concat(lo: np.ndarray, cnt: np.ndarray) -> np.ndarray:
    total = int(cnt.sum())
    out = np.ones(total, dtype=np.int64)
    if total == 0:
        return out[:0]
    offs = np.cumsum(cnt)[:-1]
    out[0] = lo[0] if len(lo) else 0
    starts = np.repeat(lo, cnt)
    idx = np.arange(total) - np.repeat(np.concatenate([[0], offs]), cnt)
    return starts + idx


def _apply_sym(rows: np.ndarray, cols: list[int],
               cons: list[tuple[int, int]]) -> np.ndarray:
    for (a, b) in cons:
        if a in cols and b in cols:
            rows = rows[rows[:, cols.index(a)] < rows[:, cols.index(b)]]
    return rows


# --------------------------------------------------------------------------- #
# Crystal-lite
# --------------------------------------------------------------------------- #
def build_triangle_index(g: Graph) -> np.ndarray:
    """All triangles (i < j < k) — the dominant part of Crystal's clique
    index. Returns (T, 3)."""
    tris = []
    for u in range(g.n):
        nu = g.neighbors(u)
        nu = nu[nu > u]
        for v in nu:
            nv = g.neighbors(int(v))
            common = np.intersect1d(nu, nv[nv > v], assume_unique=True)
            for wv in common:
                tris.append((u, int(v), int(wv)))
    return np.array(tris, dtype=np.int64).reshape(-1, 3)


def crystal_lite(pg: PartitionedGraph, pattern: Pattern, g: Graph,
                 tri_index: np.ndarray | None = None,
                 return_embeddings: bool = True) -> BaselineResult:
    """Seed from the triangle index when the pattern contains a triangle;
    expand the rest PSgL-style locally. Reports index bytes (Table 2)."""
    t0 = time.perf_counter()
    if tri_index is None:
        tri_index = build_triangle_index(g)
    index_bytes = tri_index.size * 4
    # find a pattern triangle
    tri = None
    for (a, b) in pattern.edges:
        for c in range(pattern.n):
            if c not in (a, b) and pattern.has_edge(a, c) and pattern.has_edge(b, c):
                tri = (a, b, c)
                break
        if tri:
            break
    order, steps = _order_and_filters(pattern)
    if tri is None:
        r = psgl_enumerate(pg, pattern, return_embeddings)
        r.extra["index_bytes"] = index_bytes
        r.extra["used_index"] = False
        return r
    # seed rows = triangles mapped to (a, b, c) in all 6 orientations,
    # then filter by symmetry constraints on those three columns
    perms = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]
    seeds = np.concatenate([tri_index[:, p] for p in perms], axis=0)
    # translate old ids -> renumbered ids
    seeds = pg.old2new[seeds].astype(np.int64)
    tri_cols = list(tri)
    cons = pattern.symmetry_constraints()
    seeds = _apply_sym(seeds, tri_cols, cons)
    # degree filter
    for j, u in enumerate(tri_cols):
        _, dd = _adj_rows(pg, seeds[:, j])
        seeds = seeds[dd >= pattern.degree(u)]
    rows, cols = seeds, tri_cols
    # expand remaining vertices in BFS order anchored on covered vertices
    remaining = [u for u in order if u not in cols]
    for u in remaining:
        back_all = [cols.index(wv) for wv in pattern.adj(u) if wv in cols]
        anchor, back = back_all[0], back_all[1:]
        lt = [cols.index(a) for (a, b) in cons if b == u and a in cols]
        gt = [cols.index(b) for (a, b) in cons if a == u and b in cols]
        rows = _expand(pg, rows, anchor, pattern.degree(u), back, lt, gt)
        cols = cols + [u]
    secs = time.perf_counter() - t0
    embs = _to_query_order(rows, cols, pg) if return_embeddings else None
    return BaselineResult(count=rows.shape[0], embeddings=embs,
                          bytes_shuffled=0.0, peak_rows=rows.shape[0],
                          seconds=secs,
                          extra=dict(index_bytes=index_bytes, used_index=True))
