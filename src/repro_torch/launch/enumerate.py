"""Enumeration launcher of the port (the paper's workload):
``python -m repro_torch.launch.enumerate --dataset dblp_synth --query q3``

The flags are the reference launcher's for what the port supports, plus
``--device`` (default ``cuda``).  Both storage formats (``--storage dense
| bucketed``), every wire format (``--wire raw | varint | auto``) and the
single-process exchanges (``--mode sim | gather``) run, e.g. ``--storage
bucketed --wire varint --mode gather --device cuda``.  ``--mode spmd |
dist`` runs one process per partition: launch it with ``python -m
repro_torch.launch.dist_worker``.  The reference's compile-cache and
pre-warm flags have no counterpart in an eager port.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs.rads import (CLIQUE_QUERIES, DEFAULT_ENGINE, QUERIES)
from repro_torch.core import Pattern, best_plan, rads_enumerate
from repro_torch.graph import load_dataset, partition


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="dblp_synth")
    ap.add_argument("--query", default="q1")
    ap.add_argument("--ndev", type=int, default=4)
    ap.add_argument("--partition", default="bfs",
                    choices=["bfs", "block", "hash"])
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on (cuda | cpu)")
    ap.add_argument("--no-sme", action="store_true")
    ap.add_argument("--no-steal", action="store_true")
    ap.add_argument("--mode", default="sim",
                    choices=["sim", "gather", "spmd", "dist"],
                    help="exchange backend (spmd/dist: one process per "
                         "partition, through repro_torch.launch.dist_worker)")
    ap.add_argument("--storage", default="dense",
                    choices=["dense", "bucketed"],
                    help="on-device adjacency format")
    ap.add_argument("--pipeline-depth", default="2",
                    help="max in-flight waves (1 = synchronous driver, "
                         "'auto' = adapt from per-wave timing)")
    ap.add_argument("--no-steal-groups", action="store_true",
                    help="disable steal-from-longest group-queue refill")
    ap.add_argument("--wire", default="raw",
                    choices=["raw", "varint", "auto"],
                    help="exchange wire format")
    ap.add_argument("--cache-decay", type=int, default=None,
                    help="halve cache benefit counters every N update "
                         "batches (0 = never; default "
                         f"{DEFAULT_ENGINE.cache_decay})")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the device-resident foreign-adjacency "
                         "cache (core/cache.py)")
    ap.add_argument("--cache-slots", type=int, default=None,
                    help="cache sets per device (power of two; default "
                         f"{DEFAULT_ENGINE.cache_slots})")
    ap.add_argument("--cache-ways", type=int, default=None,
                    help="cache associativity (1 = direct-mapped; default "
                         f"{DEFAULT_ENGINE.cache_ways})")
    ap.add_argument("--priors", default="",
                    help="JSON cache of per-(pattern, graph) capacity/cost "
                         "priors; preloaded before and updated after the run")
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace-event JSON of the run "
                         "(wave lanes, stage spans, dispatch->retire flow "
                         "arrows; load in Perfetto / chrome://tracing)")
    ap.add_argument("--metrics-out", default="",
                    help="export the typed metrics registry after the run: "
                         "*.prom = Prometheus textfile format, anything "
                         "else = JSON document with kind/unit/desc")
    args = ap.parse_args(argv)
    if args.mode in ("spmd", "dist"):
        ap.error(f"--mode {args.mode} runs one process per partition: "
                 f"launch it with `python -m repro_torch.launch.dist_worker "
                 f"--num-processes {args.ndev} ...` (or its launch_local)")
    depth = args.pipeline_depth if args.pipeline_depth == "auto" \
        else int(args.pipeline_depth)

    pattern = Pattern.from_edges({**QUERIES, **CLIQUE_QUERIES}[args.query])
    g = load_dataset(args.dataset)
    print(f"[enum] {args.dataset}: n={g.n} m={g.n_edges} | query {args.query} "
          f"(|V|={pattern.n}) | device {args.device}")
    pg = partition(g, args.ndev, method=args.partition)
    plan = best_plan(pattern)
    print(f"[enum] plan: {[(u.piv, u.leaves) for u in plan.units]} "
          f"rounds={plan.n_rounds} order={plan.matching_order}")
    d = DEFAULT_ENGINE
    cfg = dataclasses.replace(
        d, enable_sme=not args.no_sme,
        enable_work_stealing=not args.no_steal,
        pipeline_depth=depth,
        steal_from_longest=not args.no_steal_groups,
        storage_format=args.storage,
        enable_cache=not args.no_cache,
        cache_slots=(args.cache_slots if args.cache_slots is not None
                     else d.cache_slots),
        cache_ways=(args.cache_ways if args.cache_ways is not None
                    else d.cache_ways),
        cache_decay=(args.cache_decay if args.cache_decay is not None
                     else d.cache_decay),
        wire_format=args.wire,
        priors_path=args.priors)
    tracer = None
    if args.trace:
        from repro_torch.obs import TraceRecorder
        tracer = TraceRecorder(nvtx_bridge=args.device != "cpu")
    t0 = time.perf_counter()
    res = rads_enumerate(pg, pattern, cfg, mode=args.mode,
                         return_embeddings=False, tracer=tracer,
                         device=args.device)
    dt = time.perf_counter() - t0
    st = res.stats
    if tracer is not None:
        print(f"[enum] trace: {tracer.save(args.trace)} "
              f"({tracer.n_recorded} events, {tracer.n_dropped} dropped)")
    if args.metrics_out:
        if args.metrics_out.endswith(".prom"):
            res.registry.export_prometheus(args.metrics_out)
        else:
            res.registry.export_json(args.metrics_out)
        print(f"[enum] metrics: {args.metrics_out}")
    print(f"[enum] {res.count} embeddings in {dt:.2f}s | "
          f"SM-E seeds {st['n_sme_seeds']} dist seeds {st['n_dist_seeds']} | "
          f"fetchV {st['bytes_fetch']/1e6:.2f}MB verifyE "
          f"{st['bytes_verify']/1e6:.2f}MB | groups {st['n_groups']} "
          f"retries {st['overflow_retries']} escalations "
          f"{st['cap_escalations']}")
    print(f"[enum] storage {st['storage_format']}: "
          f"adj {st['peak_adj_bytes'] / 1e6:.2f}MB on device | "
          f"priors preloaded {st['priors_preloaded']}")
    print(f"[enum] wire {st['wire_format']}: fetch "
          f"{st['bytes_wire_fetch']/1e6:.3f}MB verify "
          f"{st['bytes_wire_verify']/1e6:.3f}MB")
    if st["cache_enabled"]:
        print(f"[enum] cache {cfg.cache_slots}x{cfg.cache_ways}: "
              f"hit-rate {st['cache_hit_rate']:.3f} "
              f"({st['cache_hits']:.0f}/{st['cache_probes']:.0f} probes) | "
              f"saved {st['bytes_saved_cache']/1e6:.2f}MB | "
              f"varint fetch {st['bytes_fetch_compressed']/1e6:.2f}MB | "
              f"resident {st['cache_bytes']/1e6:.2f}MB")
    else:
        print("[enum] cache disabled")
    print(f"[enum] pipeline: depth {st['pipeline_depth']}"
          f"{' (auto->%d)' % st['auto_depth'] if 'auto_depth' in st else ''} | "
          f"{st['n_waves']} waves, max {st['max_inflight_waves']} in flight | "
          f"steals {st['steal_events']} | "
          f"wave-time {st['wave_s_total']:.2f}s over "
          f"{st.get('dist_pipeline_s', 0.0) + st.get('sme_pipeline_s', 0.0):.2f}s wall")
    return res


if __name__ == "__main__":
    main()
