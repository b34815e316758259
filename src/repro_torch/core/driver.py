"""RADS host driver (§3.1 architecture) — setup and result assembly.

Per machine: SM-E first (border-distance split, Prop. 1), then the
distributed R-Meef phase over region groups.  Wave execution — overflow
splits, capacity escalation, queue rebalancing, the async pipeline — lives
in :mod:`repro_torch.core.scheduler`; this module

* classifies seeds (SM-E vs distributed, Prop. 1),
* puts the partition on the device (dense storage),
* builds the device-resident adjacency cache from ``EngineConfig``,
* preloads / persists the per-(pattern, graph) capacity and cost priors
  (:mod:`repro_torch.core.priors`),
* builds the per-device region-group queues (§6, Algorithm 3),
* runs the two scheduler phases, and
* assembles the :class:`EnumerationResult` (counts, embeddings, stats).

The stats dict has the reference's keys and, for the same inputs, the
same values, except wall-clock timings and the compile group: the port
runs eagerly, so ``compiles=0``, ``compile_s=0.0``,
``compile_cache_hits=0.0`` and ``exec_cache_enabled=False``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

from repro_torch.configs.rads import DEFAULT_ENGINE, EngineConfig
from repro_torch.core.cache import build_cache
from repro_torch.core.engine import PlanData, build_plan_data
from repro_torch.core.exchange import Exchange
from repro_torch.core.plan import Plan, best_plan
from repro_torch.core.priors import (HIST_BINS, hist_percentile, hist_update,
                                     load_priors, priors_key, save_priors)
from repro_torch.core.query import Pattern
from repro_torch.core.region import iter_region_groups
from repro_torch.core.scheduler import (GroupQueue, PipelineScheduler,
                                        StageRunner)
from repro_torch.core.wire import register_wire_metrics, resolve_wire_format
from repro_torch.graph.storage import PartitionedGraph, device_graph
from repro_torch.obs import NULL_TRACER, build_driver_registry


@dataclass
class EnumerationResult:
    count: int
    embeddings: set[tuple[int, ...]] | None
    stats: dict = field(default_factory=dict)
    # the typed MetricsRegistry behind ``stats`` (same values)
    registry: object = None


def extract_embeddings(rows: np.ndarray, alive: np.ndarray, pd: PlanData,
                       pg: PartitionedGraph) -> set[tuple[int, ...]]:
    """rows (ndev, cap, n_q) in matching order -> query-order tuples in
    *original* vertex ids (one vectorized unique over the whole block)."""
    r = rows[alive]
    if r.size == 0:
        return set()
    inv = np.argsort(np.array(pd.order))
    remapped = pg.new2old[r][:, inv]
    return set(map(tuple, np.unique(remapped, axis=0).tolist()))


def rads_enumerate(pg: PartitionedGraph, pattern: Pattern,
                   cfg: EngineConfig = DEFAULT_ENGINE,
                   mode: str = "sim", plan: Plan | None = None,
                   return_embeddings: bool = True,
                   tracer=None, device=None) -> EnumerationResult:
    """Enumerate every embedding of ``pattern`` in ``pg``.

    ``device=None`` runs on the card (``cuda``) and raises if there is
    none; ``device="cpu"`` runs the plain PyTorch versions of the kernels.
    This slice ports ``mode="sim"`` with dense storage and the raw wire;
    other configurations raise ``NotImplementedError`` naming their
    ROADMAP item.

    ``tracer``: optional :class:`repro_torch.obs.trace.TraceRecorder` —
    wave / stage / scheduler spans land in it for Chrome-trace export."""
    tracer = tracer if tracer is not None else NULL_TRACER
    plan = plan or best_plan(pattern, cfg.plan_rho)
    pd = build_plan_data(plan)

    # ---- capacity / cost priors (persisted §6 calibration) ---------------- #
    pkey = priors_key(pattern, pg) if cfg.priors_path else None
    prior = load_priors(cfg.priors_path).get(pkey) if pkey else None
    requested_wire = cfg.wire_format
    wire_fmt, wire_reason = resolve_wire_format(requested_wire, mode, prior)
    if wire_fmt != cfg.wire_format:
        cfg = dataclasses.replace(cfg, wire_format=wire_fmt)
    if prior:
        caps = prior.get("caps", {})
        cfg = dataclasses.replace(
            cfg,
            frontier_cap=max(cfg.frontier_cap, int(caps.get("frontier", 0))),
            fetch_cap=max(cfg.fetch_cap, int(caps.get("fetch", 0))),
            verify_cap=max(cfg.verify_cap, int(caps.get("verify", 0))))

    exch = Exchange(mode=mode, wire_format=cfg.wire_format,
                    comm_chunks=cfg.comm_chunks if cfg.comm_pipeline else 1)
    g = device_graph(pg, cfg.storage_format, device)
    runner = StageRunner(g, pd, cfg, exch, cache=build_cache(cfg, g),
                         tracer=tracer)

    # ---- candidate seeds per device: deg(v) >= deg(u_start) --------------- #
    ndev, stride = pg.ndev, pg.stride
    sme_seeds: list[np.ndarray] = []
    dist_seeds_all: list[int] = []
    for t in range(ndev):
        nl = int(pg.n_local[t])
        cand_local = np.flatnonzero(pg.deg[t, :nl] >= pd.start_deg)
        gids = cand_local + t * stride
        if cfg.enable_sme:
            is_sme = pg.border_dist[t, cand_local] >= pd.span_start
        else:
            is_sme = np.zeros(len(cand_local), dtype=bool)
        sme_seeds.append(gids[is_sme])
        dist_seeds_all.extend(map(int, gids[~is_sme]))

    stats = build_driver_registry()
    stats["n_sme_seeds"] = int(sum(len(s) for s in sme_seeds))
    stats["n_dist_seeds"] = len(dist_seeds_all)
    for k in ("bytes_fetch", "bytes_verify", "bytes_wire_fetch",
              "bytes_wire_verify", "bytes_saved_cache", "cache_hits",
              "cache_probes", "compile_cache_hits", "compile_s",
              "wave_s_total", "sme_wall_us", "dist_wall_us"):
        stats[k] = 0.0
    for k in ("n_groups", "overflow_retries", "cap_escalations",
              "sme_count", "dist_count", "n_waves", "max_inflight_waves",
              "steal_events", "compiles"):
        stats[k] = 0
    stats["bytes_wire_fetch_dev"] = np.zeros(ndev)
    stats["bytes_wire_verify_dev"] = np.zeros(ndev)
    exch.register_metrics(stats, comm_pipeline=cfg.comm_pipeline)
    register_wire_metrics(stats, cfg.wire_format, requested_wire,
                          wire_reason)
    if runner.cache is not None:
        runner.cache.register_metrics(stats)
    else:
        stats["cache_enabled"] = False
        stats["cache_bytes"] = 0
    stats["exec_cache_enabled"] = False     # eager stages: nothing to store
    stats["plan_rounds"] = plan.n_rounds
    stats["pipeline_depth"] = cfg.pipeline_depth
    stats["storage_format"] = cfg.storage_format
    stats["peak_adj_bytes"] = int(g.adj_bytes)
    stats["priors_preloaded"] = bool(prior)
    total = 0
    embs: set[tuple[int, ...]] = set()
    node_hist = np.zeros(HIST_BINS, dtype=np.int64)

    def consume(rows, alive, counts, st, phase: str):
        nonlocal total
        c = int(np.asarray(counts).sum())
        total += c
        stats[f"{phase}_count"] += c
        stats["bytes_fetch"] += float(st["bytes_fetch"])
        stats["bytes_verify"] += float(st["bytes_verify"])
        stats["bytes_wire_fetch"] += float(st["bytes_wire_fetch"])
        stats["bytes_wire_verify"] += float(st["bytes_wire_verify"])
        stats["bytes_wire_fetch_dev"] += np.asarray(
            st["bytes_wire_fetch_dev"], dtype=np.float64)
        stats["bytes_wire_verify_dev"] += np.asarray(
            st["bytes_wire_verify_dev"], dtype=np.float64)
        stats["bytes_fetch_compressed"] += float(st["bytes_fetch_compressed"])
        stats["bytes_saved_cache"] += float(st["bytes_saved_cache"])
        stats["cache_hits"] += float(st["cache_hits"])
        stats["cache_probes"] += float(st["cache_probes"])
        stats["compile_cache_hits"] += float(st["compile_cache_hits"])
        hist_update(node_hist, st["seed_node_counts"])
        if return_embeddings:
            embs.update(extract_embeddings(rows, alive, pd, pg))

    sched = PipelineScheduler(runner, stats, consume)

    # ---- SM-E phase ------------------------------------------------------- #
    per_seed_cost = 4.0 * pattern.n
    if prior and prior.get("per_seed_cost"):
        per_seed_cost = max(float(prior["per_seed_cost"]), 1.0)
    # the persisted node_counts histogram sizes waves from a high percentile
    # of the per-seed cost distribution, and the learned auto pipeline
    # depth seeds the adaptive scheduler
    prior_hist = prior.get("node_hist") if prior else None
    prior_depth = prior.get("pipeline_depth") if prior else None
    auto_start = prior_depth if cfg.pipeline_depth == "auto" else None
    if prior_hist:
        stats["prior_cost_p90"] = hist_percentile(prior_hist, 0.90)
    max_sme = max((len(s) for s in sme_seeds), default=0)
    if max_sme > 0:
        scap = 1 << (min(max_sme, 4096) - 1).bit_length()
        queues = [[np.asarray(s, dtype=np.int64)] if len(s) else []
                  for s in sme_seeds]
        c = sched.run(queues, scap, local_only=True, phase="sme",
                      auto_start=auto_start)
        if c is not None:
            per_seed_cost = max(c, 1.0)

    # ---- distributed phase: work stealing + region groups ----------------- #
    if dist_seeds_all:
        if cfg.enable_work_stealing:
            allseeds = np.array(sorted(dist_seeds_all), dtype=np.int64)
            per = -(-len(allseeds) // ndev)
            dist_seeds = [allseeds[t * per:(t + 1) * per] for t in range(ndev)]
        else:
            dist_seeds = [np.array(sorted(
                [s for s in dist_seeds_all if s // stride == t]),
                dtype=np.int64) for t in range(ndev)]

        # group formation is lazy: the scheduler pulls groups on demand,
        # so Algorithm-3 grouping of wave k+1 overlaps wave k's compute
        queues = []
        for t in range(ndev):
            est = np.full(len(dist_seeds[t]), per_seed_cost)
            queues.append(GroupQueue(
                lazy=iter_region_groups(pg, dist_seeds[t], est,
                                        float(cfg.region_group_budget),
                                        seed=cfg.seed),
                n_lazy_seeds=len(dist_seeds[t])))
        # static wave width from the grouping invariant (phi <= budget, one
        # rollback slot); with a persisted histogram the denominator is the
        # p90 per-seed cost, not the mean
        size_cost = max(per_seed_cost, 1.0)
        if prior_hist:
            size_cost = max(size_cost, hist_percentile(prior_hist, 0.90))
        max_g = int(float(cfg.region_group_budget) // size_cost)
        max_g = max(1, min(max_g + 1, max(len(s) for s in dist_seeds)))
        scap = 1 << (max_g - 1).bit_length()
        c = sched.run(queues, scap, local_only=False, phase="dist",
                      auto_start=auto_start)
        if c is not None:
            per_seed_cost = max(c, 1.0)
        stats["n_groups"] = max(q.n_formed for q in queues)

    stats["wall_us"] = (stats.get("sme_wall_us", 0.0)
                        + stats.get("dist_wall_us", 0.0))
    stats["final_caps"] = dict(frontier=runner.cfg.frontier_cap,
                               fetch=runner.cfg.fetch_cap,
                               verify=runner.cfg.verify_cap)
    stats["cache_hit_rate"] = (stats["cache_hits"] / stats["cache_probes"]
                               if stats["cache_probes"] else 0.0)
    stats["node_hist"] = node_hist.tolist()
    # per-device wire-byte attribution -> JSON-friendly lists + the skew
    fetch_dev = np.asarray(stats["bytes_wire_fetch_dev"], dtype=np.float64)
    verify_dev = np.asarray(stats["bytes_wire_verify_dev"], dtype=np.float64)
    comm_dev = fetch_dev + verify_dev
    stats["bytes_wire_fetch_dev"] = fetch_dev.tolist()
    stats["bytes_wire_verify_dev"] = verify_dev.tolist()
    stats["bytes_wire_max_dev"] = float(comm_dev.max()) if ndev else 0.0
    mean_dev = float(comm_dev.mean()) if ndev else 0.0
    stats["comm_skew"] = (float(comm_dev.max()) / mean_dev
                          if mean_dev > 0 else 1.0)
    if pkey:
        entry = dict(per_seed_cost=float(per_seed_cost),
                     caps=stats["final_caps"],
                     node_hist=node_hist.tolist())
        if "auto_depth" in stats:
            entry["pipeline_depth"] = int(stats["auto_depth"])
        elif prior_depth:                 # keep the learned depth alive
            entry["pipeline_depth"] = int(prior_depth)
        # wire trials feed resolve_wire_format's measured selection
        trials = dict(prior.get("wire_trials", {})) if prior else {}
        trials[f"{mode}:{cfg.wire_format}"] = dict(
            pipeline_s=stats["wave_s_total"],
            wire_bytes=stats["bytes_wire_fetch"] + stats["bytes_wire_verify"])
        entry["wire_trials"] = trials
        choice = dict(prior.get("wire_choice", {})) if prior else {}
        if requested_wire == "auto":
            choice[mode] = cfg.wire_format   # hysteresis anchor for next run
        if choice:
            entry["wire_choice"] = choice
        save_priors(cfg.priors_path, pkey, entry)
    return EnumerationResult(count=total,
                             embeddings=embs if return_embeddings else None,
                             stats=stats.to_stats(), registry=stats)
