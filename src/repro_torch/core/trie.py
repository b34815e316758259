"""Embedding trie (§5): prefix-sharing SoA storage of intermediate results.

TPU adaptation (DESIGN.md §2): the paper's pointer-chasing trie becomes a
structure-of-arrays — per level ``vertex``, ``parent`` (index into previous
level), ``child_count`` and ``alive`` arrays. All four paper properties are
preserved: *compression* (shared prefixes stored once), *unique ID* (leaf
row index), *retrieval* (parent-index walk), *removal* (childCount cascade).

Host-side numpy implementation: the engine computes on flat frontiers and
uses the trie as its storage/compression layer; the EL-vs-ET benchmark
(Tables 3-4) reads ``nbytes`` here.  A copy of the reference's
``core/trie.py``: the same rows give the same levels, sizes and report.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NODE_BYTES = 12  # v (4) + parentN (4) + childCount (4) — matches Def. 11


@dataclass
class TrieLevel:
    vertex: np.ndarray        # (k,) int32
    parent: np.ndarray        # (k,) int32 (index into previous level; -1 at root)
    child_count: np.ndarray   # (k,) int32
    alive: np.ndarray         # (k,) bool

    @property
    def n_alive(self) -> int:
        return int(self.alive.sum())


@dataclass
class EmbeddingTrie:
    levels: list[TrieLevel] = field(default_factory=list)

    # ------------------------------------------------------------------ #
    @staticmethod
    def from_rows(rows: np.ndarray) -> "EmbeddingTrie":
        """Merge-construction (§5 steps (1)-(4)): rows (k, depth) -> trie."""
        rows = np.asarray(rows)
        k, depth = rows.shape
        t = EmbeddingTrie()
        parent_of_row = np.full(k, -1, dtype=np.int64)
        for lvl in range(depth):
            key = np.stack([parent_of_row, rows[:, lvl]], axis=1)
            uniq, inv = np.unique(key, axis=0, return_inverse=True)
            t.levels.append(TrieLevel(
                vertex=uniq[:, 1].astype(np.int32),
                parent=uniq[:, 0].astype(np.int32),
                child_count=np.zeros(len(uniq), dtype=np.int32),
                alive=np.ones(len(uniq), dtype=bool)))
            if lvl > 0:
                np.add.at(t.levels[lvl - 1].child_count,
                          uniq[:, 0], 1)
            parent_of_row = inv
        return t

    # ------------------------------------------------------------------ #
    def materialize(self) -> np.ndarray:
        """All alive leaf-to-root paths -> rows (k, depth)."""
        if not self.levels:
            return np.zeros((0, 0), dtype=np.int32)
        depth = len(self.levels)
        leaf = self.levels[-1]
        ids = np.flatnonzero(leaf.alive)
        out = np.zeros((len(ids), depth), dtype=np.int32)
        cur = ids
        for lvl in range(depth - 1, -1, -1):
            out[:, lvl] = self.levels[lvl].vertex[cur]
            cur = self.levels[lvl].parent[cur]
        return out

    def remove_result(self, leaf_id: int) -> None:
        """Removal with childCount cascade (§5.1 'Removal'): kill the leaf,
        decrement its parent's childCount; if that reaches 0 the parent is
        removed too, recursively."""
        lvl = len(self.levels) - 1
        node = leaf_id
        while lvl >= 0 and node >= 0:
            level = self.levels[lvl]
            level.alive[node] = False
            if lvl == 0:
                break
            parent = int(level.parent[node])
            self.levels[lvl - 1].child_count[parent] -= 1
            if self.levels[lvl - 1].child_count[parent] > 0:
                break
            node = parent
            lvl -= 1

    def filter_leaves(self, keep: np.ndarray) -> None:
        """Vectorized bulk removal: keep (n_alive_leaves,) bool in alive order."""
        leaf = self.levels[-1]
        ids = np.flatnonzero(leaf.alive)
        drop = ids[~np.asarray(keep)]
        for leaf_id in drop:
            self.remove_result(int(leaf_id))

    # ------------------------------------------------------------------ #
    @property
    def nbytes(self) -> int:
        return sum(lv.n_alive * NODE_BYTES for lv in self.levels)

    @property
    def n_nodes(self) -> int:
        return sum(lv.n_alive for lv in self.levels)

    @property
    def n_results(self) -> int:
        return self.levels[-1].n_alive if self.levels else 0


def embedding_list_bytes(rows: np.ndarray) -> int:
    """The EL baseline: flat (k, depth) int32 rows."""
    return int(rows.shape[0] * rows.shape[1] * 4)


def compression_report(rows: np.ndarray) -> dict:
    t = EmbeddingTrie.from_rows(rows)
    el = embedding_list_bytes(rows)
    et = t.nbytes
    return dict(n_results=int(rows.shape[0]), el_bytes=el, et_bytes=et,
                ratio=el / max(et, 1))
