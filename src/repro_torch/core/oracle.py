"""Brute-force single-machine subgraph-enumeration oracle (correctness ref).

Backtracking over pattern vertices in a fixed order, enforcing edges,
injectivity and the same symmetry-breaking constraints as the engines, so
result *sets* (not just counts) are directly comparable.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.query import Pattern
from repro_torch.graph.storage import Graph


def enumerate_oracle(graph: Graph, pattern: Pattern,
                     order: tuple[int, ...] | None = None,
                     constraints: list[tuple[int, int]] | None = None,
                     ) -> set[tuple[int, ...]]:
    """Return the set of embeddings as tuples indexed by *query vertex id*
    (i.e., result[u] = data vertex matched to query vertex u)."""
    n = pattern.n
    if order is None:
        # BFS order from vertex 0 keeps each new vertex adjacent to a prior one
        order = _bfs_order(pattern)
    if constraints is None:
        constraints = pattern.symmetry_constraints()
    pos = {u: i for i, u in enumerate(order)}
    # per-step: edges back to already-mapped vertices; symmetry pairs ready
    back_edges: list[list[int]] = []
    sym_lt: list[list[int]] = []  # f(u') < f(u) required, u' mapped earlier
    sym_gt: list[list[int]] = []  # f(u) < f(u') required
    for i, u in enumerate(order):
        back_edges.append([w for w in pattern.adj(u) if pos[w] < i])
        lt, gt = [], []
        for (a, b) in constraints:
            if b == u and pos[a] < i:
                lt.append(a)
            if a == u and pos[b] < i:
                gt.append(b)
        sym_lt.append(lt)
        sym_gt.append(gt)

    results: set[tuple[int, ...]] = set()
    mapping = np.full(n, -1, dtype=np.int64)
    used: set[int] = set()
    deg = pattern.degrees()

    def rec(i: int):
        if i == n:
            results.add(tuple(int(x) for x in mapping))
            return
        u = order[i]
        if i == 0:
            cand = range(graph.n)
        else:
            anchor = back_edges[i][0]
            cand = graph.neighbors(mapping[anchor])
        for v in cand:
            v = int(v)
            if v in used:
                continue
            if len(graph.neighbors(v)) < deg[u]:
                continue
            if any(not graph.has_edge(mapping[w], v) for w in back_edges[i]):
                continue
            if any(mapping[w] >= v for w in sym_lt[i]):
                continue
            if any(mapping[w] <= v for w in sym_gt[i]):
                continue
            mapping[u] = v
            used.add(v)
            rec(i + 1)
            used.discard(v)
            mapping[u] = -1

    rec(0)
    return results


def _bfs_order(pattern: Pattern) -> tuple[int, ...]:
    order = [0]
    seen = {0}
    i = 0
    while len(order) < pattern.n:
        u = order[i]
        i += 1
        for w in pattern.adj(u):
            if w not in seen:
                seen.add(w)
                order.append(w)
    return tuple(order)


def count_oracle(graph: Graph, pattern: Pattern) -> int:
    return len(enumerate_oracle(graph, pattern))


def canonicalize(embs: set[tuple[int, ...]], pattern: Pattern
                 ) -> set[tuple[int, ...]]:
    """Map each embedding to the lexicographically-smallest member of its
    automorphism class. Engines break symmetry on *renumbered* vertex ids,
    so representative choice may differ from the oracle's — canonical forms
    are the comparable invariant (and set sizes must be preserved)."""
    autos = pattern.automorphisms()
    out = set()
    for e in embs:
        out.add(min(tuple(e[a[u]] for u in range(pattern.n)) for a in autos))
    assert len(out) == len(embs), "duplicate embeddings within a class"
    return out
