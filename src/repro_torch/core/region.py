"""Region groups — memory-control strategy (§6, Algorithm 3).

The candidate set of ``dp0.piv`` on each device is split into groups whose
*estimated* memory cost (trie nodes, calibrated from the SM-E pass) fits the
budget; groups are processed sequentially. Grouping maximizes neighborhood
sharing via the paper's ``proximity`` measure (Eq. 5) for small candidate
sets, falling back to sorted-id blocks (block partitions make id-adjacent
vertices neighborhood-similar) for large ones.

Both strategies are *incremental* generators (``iter_*``): Algorithm 3
grows one group at a time, so the async wave scheduler pulls groups on
demand and the (Python-side) grouping of wave ``k+1`` overlaps the device
compute of wave ``k``.  The list-returning wrappers run the generators to
exhaustion and are what the synchronous callers and the tests use; the
generator and list forms produce *identical* groups (same RNG stream).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.graph.storage import PartitionedGraph


def iter_proximity_groups(pg: PartitionedGraph, cands: np.ndarray,
                          est_cost: np.ndarray, budget: float,
                          seed: int = 0) -> Iterator[np.ndarray]:
    """Algorithm 3, one group per ``next()`` (run to exhaustion for all)."""
    rng = np.random.default_rng(seed)
    remaining = list(map(int, cands))
    cost = {int(v): float(c) for v, c in zip(cands, est_cost)}
    while remaining:
        i = int(rng.integers(len(remaining)))
        v0 = remaining.pop(i)
        rg = [v0]
        phi = cost[v0]
        nbr_set = set(map(int, pg.neighbors(v0)))
        while remaining and phi < budget:
            # argmax proximity(v, rg) = |adj(v) ∩ N(rg)| / |adj(v)|   (Eq. 5)
            best_j, best_p = 0, -1.0
            for j, v in enumerate(remaining):
                nb = pg.neighbors(v)
                if len(nb) == 0:
                    p = 0.0
                else:
                    p = sum(1 for x in nb if int(x) in nbr_set) / len(nb)
                if p > best_p:
                    best_j, best_p = j, p
            v = remaining.pop(best_j)
            if phi + cost[v] > budget and len(rg) >= 1:
                remaining.append(v)        # Alg. 3 line 8-9: roll back
                break
            rg.append(v)
            phi += cost[v]
            nbr_set.update(map(int, pg.neighbors(v)))
        yield np.array(rg, dtype=np.int64)


def iter_block_groups(cands: np.ndarray, est_cost: np.ndarray,
                      budget: float) -> Iterator[np.ndarray]:
    """Sorted-id greedy packing (locality from block partitioning)."""
    order = np.argsort(cands)
    cands, est_cost = cands[order], est_cost[order]
    cur, phi = [], 0.0
    for v, c in zip(cands, est_cost):
        if cur and phi + c > budget:
            yield np.array(cur, dtype=np.int64)
            cur, phi = [], 0.0
        cur.append(int(v))
        phi += float(c)
    if cur:
        yield np.array(cur, dtype=np.int64)


def iter_region_groups(pg: PartitionedGraph, cands: np.ndarray,
                       est_cost: np.ndarray, budget: float,
                       proximity_threshold: int = 256,
                       seed: int = 0) -> Iterator[np.ndarray]:
    if len(cands) == 0:
        return iter(())
    if len(cands) <= proximity_threshold:
        return iter_proximity_groups(pg, cands, est_cost, budget, seed)
    return iter_block_groups(cands, est_cost, budget)


def proximity_groups(pg: PartitionedGraph, cands: np.ndarray,
                     est_cost: np.ndarray, budget: float,
                     seed: int = 0) -> list[np.ndarray]:
    return list(iter_proximity_groups(pg, cands, est_cost, budget, seed))


def block_groups(cands: np.ndarray, est_cost: np.ndarray,
                 budget: float) -> list[np.ndarray]:
    return list(iter_block_groups(cands, est_cost, budget))


def make_region_groups(pg: PartitionedGraph, cands: np.ndarray,
                       est_cost: np.ndarray, budget: float,
                       proximity_threshold: int = 256,
                       seed: int = 0) -> list[np.ndarray]:
    return list(iter_region_groups(pg, cands, est_cost, budget,
                                   proximity_threshold, seed))
