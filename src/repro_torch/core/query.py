"""Query patterns: automorphism-based symmetry breaking, span, distances (§2)."""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class Pattern:
    """Unlabeled, undirected, connected query pattern (3-10 vertices)."""

    n: int
    edges: frozenset[tuple[int, int]]  # canonical (min, max) pairs

    @staticmethod
    def from_edges(edges) -> "Pattern":
        es = frozenset((min(a, b), max(a, b)) for a, b in edges if a != b)
        n = max(max(e) for e in es) + 1
        p = Pattern(n=n, edges=es)
        if not p.is_connected():
            raise ValueError("pattern must be connected")
        return p

    def has_edge(self, a: int, b: int) -> bool:
        return (min(a, b), max(a, b)) in self.edges

    def adj(self, u: int) -> list[int]:
        out = []
        for (a, b) in self.edges:
            if a == u:
                out.append(b)
            elif b == u:
                out.append(a)
        return sorted(out)

    def degree(self, u: int) -> int:
        return len(self.adj(u))

    def degrees(self) -> np.ndarray:
        return np.array([self.degree(u) for u in range(self.n)], dtype=np.int32)

    def is_connected(self) -> bool:
        seen = {0}
        stack = [0]
        while stack:
            u = stack.pop()
            for w in self.adj(u):
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        return len(seen) == self.n

    def distances(self) -> np.ndarray:
        """All-pairs shortest path (BFS per vertex)."""
        n = self.n
        d = np.full((n, n), n + 1, dtype=np.int32)
        for s in range(n):
            d[s, s] = 0
            frontier = [s]
            dd = 0
            while frontier:
                dd += 1
                nxt = []
                for u in frontier:
                    for w in self.adj(u):
                        if d[s, w] > dd:
                            d[s, w] = dd
                            nxt.append(w)
                frontier = nxt
        return d

    def span(self, u: int) -> int:
        """Definition 2: max shortest distance from u to any other vertex."""
        return int(self.distances()[u].max())

    def automorphisms(self) -> list[tuple[int, ...]]:
        autos = []
        deg = tuple(self.degree(u) for u in range(self.n))
        for perm in itertools.permutations(range(self.n)):
            if tuple(deg[perm[u]] for u in range(self.n)) != deg:
                continue
            if all(self.has_edge(perm[a], perm[b]) for (a, b) in self.edges):
                autos.append(perm)
        return autos

    def symmetry_constraints(self) -> list[tuple[int, int]]:
        """Grochow-Kellis symmetry breaking [8]: returns pairs (a, b) meaning
        every reported embedding must satisfy f(a) < f(b). Guarantees each
        isomorphic image is enumerated exactly once."""
        A = self.automorphisms()
        constraints: list[tuple[int, int]] = []
        while len(A) > 1:
            u = None
            for cand in range(self.n):
                orbit = {a[cand] for a in A}
                if len(orbit) > 1:
                    u = cand
                    break
            if u is None:
                break
            orbit = {a[u] for a in A}
            for v in sorted(orbit - {u}):
                constraints.append((u, v))
            A = [a for a in A if a[u] == u]
        return constraints
