"""Declared metric schema — the single source of truth for stats keys.

Every key :func:`repro_torch.core.driver.rads_enumerate` can emit is declared
here as a typed :class:`~repro_torch.obs.metrics.Instrument`; the driver
builds its ``stats`` object from :func:`build_driver_registry`.  The
declarations are the reference package's, key for key, so the port and
the reference report the same stats.

Group tuples mirror which subsystem *owns* the instrument — scheduler,
exchange/wire, AdjCache, compile pipeline — matching who registers or
writes it at runtime.  The compile group counts the stage executables
(CUDA graphs) of :class:`~repro_torch.core.scheduler.StageRunner` and the
per-host store of :mod:`repro_torch.runtime.compile_cache`; where the
stages run eagerly (the CPU, ``spmd``/``dist``) it reports zeros and
``exec_cache_enabled`` is False.
"""
from __future__ import annotations

from repro_torch.obs.metrics import (COUNTER, GAUGE, HISTOGRAM, INFO, Instrument,
                               MetricsRegistry)

__all__ = ["counter", "gauge", "info", "histogram", "build_driver_registry",
           "DRIVER_SCHEMA", "SCHEDULER_SCHEMA", "EXCHANGE_SCHEMA",
           "CACHE_SCHEMA", "COMPILE_SCHEMA", "WIRE_SCHEMA"]


def counter(name: str, unit: str = "", desc: str = "") -> Instrument:
    return Instrument(name, COUNTER, unit, desc)


def gauge(name: str, unit: str = "", desc: str = "") -> Instrument:
    return Instrument(name, GAUGE, unit, desc)


def info(name: str, desc: str = "") -> Instrument:
    return Instrument(name, INFO, "", desc)


def histogram(name: str, unit: str = "", desc: str = "") -> Instrument:
    return Instrument(name, HISTOGRAM, unit, desc)


# -- driver: seed classification, plan, result assembly ---------------------- #
DRIVER_SCHEMA = (
    gauge("n_sme_seeds", "", "seeds eligible for the machine-local SM-E phase"),
    gauge("n_dist_seeds", "", "seeds requiring the distributed R-Meef phase"),
    counter("n_groups", "", "Algorithm-3 region groups formed (max per dev)"),
    gauge("plan_rounds", "", "rounds in the chosen matching plan"),
    counter("sme_count", "", "embeddings found in the SM-E phase"),
    counter("dist_count", "", "embeddings found in the distributed phase"),
    gauge("storage_format", "", "on-device adjacency layout"),
    gauge("peak_adj_bytes", "bytes", "resident adjacency footprint"),
    gauge("priors_preloaded", "", "persisted capacity/cost priors were used"),
    gauge("prior_cost_p90", "", "p90 per-seed cost from the persisted hist"),
    histogram("node_hist", "", "per-seed node-count histogram (priors v2)"),
    gauge("final_caps", "", "frontier/fetch/verify caps after escalation"),
)

# -- scheduler: waves, robustness loop, wall attribution ---------------------- #
SCHEDULER_SCHEMA = (
    counter("n_waves", "", "waves retired across both phases"),
    gauge("max_inflight_waves", "", "peak waves concurrently in flight"),
    counter("steal_events", "", "checkR/shareR queue steals"),
    counter("overflow_retries", "", "overflow-driven group splits (§6)"),
    counter("cap_escalations", "", "elastic capacity escalations (§6)"),
    counter("wave_s_total", "s", "summed wave dispatch->retire wall"),
    gauge("pipeline_depth", "", "configured pipeline depth ('auto' adapts)"),
    gauge("auto_depth", "", "depth the adaptive scheduler settled on"),
    counter("sme_pipeline_s", "s", "SM-E phase pipeline wall (perf_counter)"),
    counter("dist_pipeline_s", "s", "dist phase pipeline wall (perf_counter)"),
    counter("sme_wall_us", "us", "SM-E phase wall on the span clock"),
    counter("dist_wall_us", "us", "dist phase wall on the span clock"),
    counter("wall_us", "us", "total phase wall on the span clock "
                             "(max-merged across processes)"),
    gauge("wall_skew", "", "max/mean per-process wall_us after merge"),
    gauge("per_process_wall_us", "us", "per-process wall_us list after merge"),
)

# -- exchange backends: wire traffic + process topology ----------------------- #
EXCHANGE_SCHEMA = (
    gauge("process_index", "", "this process's index in the dist job"),
    gauge("process_count", "", "processes participating in the dist job"),
    gauge("comm_pipeline", "", "pipelined group communication enabled"),
    gauge("comm_chunks", "", "communication chunks per group exchange"),
    counter("bytes_fetch", "bytes", "raw fetchV byte accounting"),
    counter("bytes_verify", "bytes", "raw verifyE byte accounting"),
    counter("bytes_wire_fetch", "bytes", "actual coded fetchV wire bytes"),
    counter("bytes_wire_verify", "bytes", "actual coded verifyE wire bytes"),
    histogram("bytes_wire_fetch_dev", "bytes", "per-device fetch wire bytes"),
    histogram("bytes_wire_verify_dev", "bytes", "per-device verify wire bytes"),
    gauge("bytes_wire_max_dev", "bytes", "max per-device total wire bytes"),
    gauge("comm_skew", "", "max/mean per-device wire bytes"),
)

# -- AdjCache: device-resident foreign-adjacency cache ------------------------- #
CACHE_SCHEMA = (
    gauge("cache_enabled", "", "AdjCache constructed for this run"),
    gauge("cache_bytes", "bytes", "AdjCache slab footprint"),
    counter("cache_hits", "", "AdjCache probe hits"),
    counter("cache_probes", "", "AdjCache probes"),
    gauge("cache_hit_rate", "", "hits/probes for this run"),
    counter("bytes_saved_cache", "bytes", "wire bytes avoided by cache hits"),
)

# -- compile pipeline: stage graphs + persistent executable store ------------- #
COMPILE_SCHEMA = (
    counter("compiles", "", "stage graphs captured this call without "
            "the store"),
    counter("compile_s", "s", "wall spent in their warm-up and capture"),
    counter("compile_cache_hits", "", "StageRunner slot/store hits"),
    gauge("exec_cache_enabled", "", "persistent executable store active"),
    gauge("exec_cache", "", "StageExecCache counter deltas for this call"),
)

# -- wire codecs ---------------------------------------------------------------- #
WIRE_SCHEMA = (
    info("wire_format", "codec actually used on the wire"),
    info("wire_format_requested", "codec requested by EngineConfig"),
    info("wire_auto_reason", "why measured auto-selection chose the codec"),
    counter("bytes_fetch_compressed", "bytes",
            "modeled compressed fetch baseline"),
)

_ALL_GROUPS = (DRIVER_SCHEMA, SCHEDULER_SCHEMA, EXCHANGE_SCHEMA,
               CACHE_SCHEMA, COMPILE_SCHEMA, WIRE_SCHEMA)


def build_driver_registry() -> MetricsRegistry:
    """Fresh per-run registry declaring every instrument the driver,
    scheduler, exchange, caches, and wire codecs may write."""
    reg = MetricsRegistry()
    for group in _ALL_GROUPS:
        for ins in group:
            reg.register(Instrument(ins.name, ins.kind, ins.unit, ins.desc))
    return reg
