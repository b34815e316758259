"""Quickstart of the PyTorch port: enumerate triangles (and a 5-vertex
pattern) on a synthetic DBLP-like graph partitioned over 4 'machines',
with the full RADS pipeline (plan, SM-E split, region groups, fetchV and
verifyE exchanges), and hold each count against the PSgL baseline.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import time

from repro_torch.configs.rads import QUERIES, EngineConfig
from repro_torch.core import Pattern, best_plan, rads_enumerate
from repro_torch.core.baselines import psgl_enumerate
from repro_torch.graph import load_dataset, partition

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
args = ap.parse_args()

g = load_dataset("dblp_bench")
print(f"data graph: {g.n} vertices, {g.n_edges} edges, "
      f"max degree {g.max_degree}")
pg = partition(g, 4, method="bfs")

for qname in ("q1", "q5"):
    pattern = Pattern.from_edges(QUERIES[qname])
    plan = best_plan(pattern)
    print(f"\n=== {qname}: {pattern.n} vertices, "
          f"{len(pattern.edges)} edges ===")
    print("execution plan:", [(u.piv, u.leaves) for u in plan.units],
          f"({plan.n_rounds} rounds, matching order {plan.matching_order})")
    t0 = time.perf_counter()
    cfg = EngineConfig(frontier_cap=1 << 13, fetch_cap=1 << 10,
                       verify_cap=1 << 12, region_group_budget=1 << 12)
    res = rads_enumerate(pg, pattern, cfg, mode="sim",
                         return_embeddings=False, device=args.device)
    dt = time.perf_counter() - t0
    st = res.stats
    print(f"RADS on {args.device}: {res.count} embeddings in {dt:.2f}s | "
          f"SM-E seeds {st['n_sme_seeds']}/"
          f"{st['n_sme_seeds'] + st['n_dist_seeds']} | "
          f"fetchV {st['bytes_fetch'] / 1e3:.1f}KB verifyE "
          f"{st['bytes_verify'] / 1e3:.1f}KB | adj-cache hit-rate "
          f"{st['cache_hit_rate']:.2f} (saved "
          f"{st['bytes_saved_cache'] / 1e3:.1f}KB)")
    base = psgl_enumerate(pg, pattern, return_embeddings=False)
    print(f"PSgL baseline: {base.count} embeddings, shuffled "
          f"{base.bytes_shuffled / 1e3:.1f}KB (RADS ships "
          f"{base.bytes_shuffled / max(st['bytes_fetch'] + st['bytes_verify'], 1):.1f}x less)")
    if base.count != res.count:
        raise SystemExit(f"{qname}: RADS counted {res.count}, PSgL "
                         f"{base.count}")
