"""Cross-run capacity / cost priors (§6 calibration, persisted).

The engine calibrates two things while it runs: the per-seed trie-node
cost (the region-group budget denominator, running mean over every
completed wave) and the static engine capacities (doubled on overflow —
each escalation discards the overflowing wave and runs it again).  Both
are pure functions of the (pattern, data graph) workload, so persisting
them lets the *next* run on the same workload start with the right
capacities — skipping the escalation ladder entirely — and with a realistic
per-seed cost for region-group sizing instead of the cold-start guess.

Priors v2 additionally persists, per workload:

* the **per-seed node_counts histogram** (log2-binned trie-node counts
  over every completed seed) — the next run sizes its region-group waves
  from a high percentile of the *distribution* instead of the mean, so
  skewed seed-degree workloads stop overflowing on the hub-heavy groups;
* the **learned pipeline depth** — the depth ``pipeline_depth="auto"``
  converged to, used as the next run's starting depth.

The cache is a flat JSON file (``EngineConfig.priors_path``) mapping a
workload key — canonical pattern edge list + graph fingerprint
(vertices, edges, ndev) — to ``{"per_seed_cost": float, "caps": {...},
"node_hist": [...], "pipeline_depth": int}``.  Writes are merge +
atomic-rename under an advisory file lock so concurrent runs on
different workloads can share one cache file.
"""
from __future__ import annotations

import json
import os

import numpy as np

from repro_torch.core.query import Pattern
from repro_torch.graph.storage import PartitionedGraph

# log2 bins for the per-seed trie-node-count histogram: bin i counts seeds
# with ceil(log2(nodes + 1)) == i, i.e. nodes in [2^(i-1), 2^i).
HIST_BINS = 24


def priors_key(pattern: Pattern, pg: PartitionedGraph) -> str:
    """Workload fingerprint: canonical query edges + data-graph identity."""
    edges = ";".join(f"{a}-{b}" for a, b in sorted(pattern.edges))
    m = int(pg.deg.sum()) // 2
    return f"q[{edges}]|g[n={pg.n_real},m={m},ndev={pg.ndev}]"


def hist_update(hist: np.ndarray, node_counts: np.ndarray) -> None:
    """Accumulate per-seed trie-node counts into a log2-binned histogram
    (in place).  ``hist``: (HIST_BINS,) int64; ``node_counts``: (k,)."""
    nc = np.asarray(node_counts)
    if nc.size == 0:
        return
    bins = np.zeros(nc.shape, dtype=np.int64)
    pos = nc > 0
    bins[pos] = np.minimum(
        np.ceil(np.log2(nc[pos] + 1.0)).astype(np.int64), HIST_BINS - 1)
    np.add.at(hist, bins, 1)


def hist_percentile(hist, q: float) -> float:
    """Upper-edge cost estimate of the ``q``-quantile histogram bin
    (``2^i`` for bin ``i``) — the wave-sizing denominator for priors v2."""
    h = np.asarray(hist, dtype=np.float64)
    total = h.sum()
    if total <= 0:
        return 1.0
    idx = int(np.searchsorted(np.cumsum(h), q * total))
    return float(2 ** min(idx, HIST_BINS - 1))


def load_priors(path: str) -> dict:
    """Read the cache; missing or corrupt files are an empty prior."""
    try:
        with open(path) as f:
            out = json.load(f)
        return out if isinstance(out, dict) else {}
    except (OSError, json.JSONDecodeError):
        return {}


def save_priors(path: str, key: str, entry: dict) -> None:
    """Merge ``entry`` under ``key`` and atomically rewrite the cache.

    The read-merge-replace runs under an advisory ``flock`` on a sibling
    lock file (where the platform has one), so concurrent runs finishing
    at the same time don't drop each other's entries."""
    lock = open(f"{path}.lock", "w")
    try:
        try:
            import fcntl
            fcntl.flock(lock, fcntl.LOCK_EX)
        except (ImportError, OSError):
            pass                     # no flock: fall back to atomic rename
        cur = load_priors(path)
        cur[key] = entry
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(cur, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    finally:
        lock.close()
