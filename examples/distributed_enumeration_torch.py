"""End-to-end distributed driver of the PyTorch port (the paper's kind of
workload): run the R-Meef engine as 8 processes, one rank per partition
over ``torch.distributed`` (gloo), with real ``all_to_all_single``
fetchV/verifyE exchanges between them, and hold the count against the
single-machine oracle.

    PYTHONPATH=src python examples/distributed_enumeration_torch.py [--device cpu]

The ranks run on the card unless ``--device cpu`` is given (all 8 may
share one card).
"""
import argparse
import sys
import time

from repro_torch.configs.rads import QUERIES
from repro_torch.core import Pattern, count_oracle, merge_process_stats
from repro_torch.graph import load_dataset
from repro_torch.launch.dist_worker import launch_local

NDEV = 8
ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
args = ap.parse_args()

g = load_dataset("dblp_bench")
for qname in ("q1",):
    pattern = Pattern.from_edges(QUERIES[qname])
    t0 = time.perf_counter()
    workers = launch_local(NDEV, [
        "--dataset", "dblp_bench", "--query", qname, "--partition", "bfs",
        "--frontier-cap", str(1 << 14), "--fetch-cap", str(1 << 10),
        "--verify-cap", str(1 << 12), "--region-budget", str(1 << 13),
        "--device", args.device], timeout_s=900.0)
    dt = time.perf_counter() - t0
    if workers is None:
        sys.exit("torch.distributed with gloo is not available here")
    st = merge_process_stats([w["stats"] for w in workers])
    counts = {int(w["count"]) for w in workers}
    oracle = count_oracle(g, pattern)
    ok = counts == {oracle}
    print(f"{qname}: {counts} embeddings in {dt:.1f}s on {NDEV} ranks "
          f"| oracle {oracle} match: {ok} | fetchV "
          f"{st['bytes_fetch']/1e3:.1f}KB verifyE {st['bytes_verify']/1e3:.1f}KB "
          f"| groups {st['n_groups']} | wall skew {st['wall_skew']:.2f}")
    assert ok
print("distributed enumeration verified against oracle.")
