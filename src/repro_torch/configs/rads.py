"""Config for the paper's own workload: distributed subgraph enumeration.

Defines the engine knobs (capacities, region-group budget, caching) and the
synthetic stand-ins for the paper's four datasets plus the q1..q8 /
qc1..qc4 query sets.  A field-for-field copy of the reference package's
config, so one kwargs dict builds both configs in a parity test.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass(frozen=True)
class EngineConfig:
    """RADS / R-Meef engine knobs (all static — they fix tensor shapes)."""

    frontier_cap: int = 1 << 16        # max live partial embeddings per device
    max_degree: int = 64               # padded adjacency window for expansion
    fetch_cap: int = 1 << 12           # max foreign-vertex fetches per round/peer
    verify_cap: int = 1 << 14          # max undetermined-edge queries per round/peer
    region_group_budget: int = 1 << 14 # memory-control target: est. trie nodes/group
    enable_sme: bool = True            # SM-E local/distributed split (Prop. 1)
    # --- foreign-adjacency cache (core/cache.py AdjCache) ------------------- #
    enable_cache: bool = True          # device-resident fetchV row cache (§7)
    cache_slots: int = 1 << 12         # sets per device (must be a power of 2:
                                       # the set index is `v & (slots - 1)`)
    cache_ways: int = 2                # associativity (1 = direct-mapped)
    cache_decay: int = 0               # shared-benefit decay period: every
                                       # `cache_decay` update batches the live
                                       # benefit counters are halved (>> 1) so
                                       # stale hub lines stop pinning the cache
                                       # across phases (0 = no decay)
    enable_work_stealing: bool = True  # checkR/shareR analogue (seed rebalance)
    # --- exchange wire format (core/wire.py codecs) ------------------------- #
    wire_format: str = "raw"           # 'raw' (int32 slabs, the reference) |
                                       # 'varint' (delta+varint / Elias-Fano
                                       # coded u8 streams on the wire; results
                                       # are wire-format-invariant) |
                                       # 'auto' (measured per-run selection
                                       # from persisted wire trials — see
                                       # core/wire.py resolve_wire_format;
                                       # requires priors_path to learn)
    plan_rho: float = 1.0              # score-function exponent (paper uses 1)
    seed: int = 0
    # --- on-device adjacency storage (graph/storage.py DeviceGraph) --------- #
    storage_format: str = "dense"      # 'dense' (reference) | 'bucketed'
                                       # (degree-bucketed CSR slabs, decouples
                                       # adjacency memory from the worst hub)
    # --- async wave scheduler (core/scheduler.py) --------------------------- #
    pipeline_depth: int | str = 2      # max in-flight waves (1 = synchronous,
                                       # "auto" = adapt from per-wave timing)
    steal_from_longest: bool = True    # refill drained group queues (checkR/shareR)
    # --- cross-run priors (core/priors.py) ---------------------------------- #
    priors_path: str = ""              # JSON cache of per-(pattern, graph)
                                       # capacity/cost priors ("" = disabled)
    # --- pipelined group communication (core/exchange.py) ------------------- #
    comm_pipeline: bool = False        # split each wave's a2a into comm_chunks
                                       # back-to-back sub-exchanges so chunk
                                       # k's transfer overlaps chunk k+1's
                                       # encode/decode (arXiv:1804.09764-style
                                       # pipelined groups; bit-identical)
    comm_chunks: int = 4               # sub-exchanges per a2a when
                                       # comm_pipeline is on (power of two so
                                       # it divides the capacity-ladder axes)
    # --- persistent stage-executable cache (runtime/compile_cache.py) ------- #
    compile_cache_dir: str = ""        # per-host on-disk store of serialized
                                       # stage executables ("" = disabled);
                                       # with priors v2 a warm run performs
                                       # zero traces/compiles
    compile_cache_budget_bytes: int = 0  # LRU size budget for the store: on
                                       # every save, least-recently-used
                                       # .stagex envelopes (file mtime) are
                                       # evicted until the store fits
                                       # (0 = unbounded, the old behaviour)
    prewarm: bool = True               # resolve the stage ladder on a
                                       # background thread during group
                                       # formation (off the critical path)
    # --- accelerator kernels ------------------------------------------------ #
    use_pallas_kernels: bool = False   # kept so one kwargs dict builds both
                                       # configs; the port does not read it:
                                       # the tensor's device picks the path
                                       # (CUDA kernel on the card, plain
                                       # torch version on the CPU)

    def __post_init__(self):
        # RL002's runtime twin: every escalation doubles the caps, and the
        # priors cache warm-starts from persisted (doubled) values — caps on
        # the power-of-two ladder are the invariant that makes a warm start
        # land exactly on an already-built stage instead of re-tracing
        for name in ("frontier_cap", "fetch_cap", "verify_cap"):
            v = getattr(self, name)
            if v <= 0 or (v & (v - 1)):
                raise ValueError(
                    f"{name} must be a positive power of two (capacity "
                    f"escalation ladder / warm starts), got {v}")
        if self.cache_slots <= 0 or (self.cache_slots
                                     & (self.cache_slots - 1)):
            raise ValueError(
                f"cache_slots must be a positive power of two (the set "
                f"index is a bitmask), got {self.cache_slots}")
        if self.cache_ways < 1:
            raise ValueError(f"cache_ways must be >= 1, got {self.cache_ways}")
        if self.cache_decay < 0:
            raise ValueError(
                f"cache_decay must be >= 0 (0 disables the benefit decay "
                f"schedule), got {self.cache_decay}")
        if self.wire_format not in ("raw", "varint", "auto"):
            raise ValueError(
                f"wire_format must be 'raw', 'varint' or 'auto', "
                f"got {self.wire_format!r}")
        if not isinstance(self.compile_cache_dir, str):
            raise ValueError(
                f"compile_cache_dir must be a directory path string "
                f"('' disables the executable store), "
                f"got {self.compile_cache_dir!r}")
        if self.compile_cache_dir and os.path.exists(self.compile_cache_dir) \
                and not os.path.isdir(self.compile_cache_dir):
            raise ValueError(
                f"compile_cache_dir exists but is not a directory: "
                f"{self.compile_cache_dir!r}")
        if not isinstance(self.prewarm, bool):
            raise ValueError(
                f"prewarm must be a bool (background stage pre-warm), "
                f"got {self.prewarm!r}")
        if not isinstance(self.comm_pipeline, bool):
            raise ValueError(
                f"comm_pipeline must be a bool (pipelined group "
                f"communication), got {self.comm_pipeline!r}")
        if (not isinstance(self.comm_chunks, int) or self.comm_chunks < 1
                or (self.comm_chunks & (self.comm_chunks - 1))):
            raise ValueError(
                f"comm_chunks must be a positive power of two (so chunks "
                f"divide the power-of-two capacity axes evenly), "
                f"got {self.comm_chunks!r}")
        if (not isinstance(self.compile_cache_budget_bytes, int)
                or isinstance(self.compile_cache_budget_bytes, bool)
                or self.compile_cache_budget_bytes < 0):
            raise ValueError(
                f"compile_cache_budget_bytes must be an int >= 0 "
                f"(0 = unbounded store), "
                f"got {self.compile_cache_budget_bytes!r}")


# dataset stand-ins: name -> generator kwargs (see graph/generators.py)
DATASETS: dict[str, dict] = {
    # sparse, huge diameter (RoadNet-like): 2-D lattice with perturbation
    "roadnet_synth": dict(kind="road", n=4096),
    # small, moderately dense, community structure (DBLP-like)
    "dblp_synth": dict(kind="powerlaw", n=2000, avg_deg=7, seed=1),
    # dense social graph (LiveJournal-like)
    "livejournal_synth": dict(kind="powerlaw", n=6000, avg_deg=18, seed=2),
    # densest web graph (UK2002-like)
    "uk2002_synth": dict(kind="powerlaw", n=8000, avg_deg=32, seed=3),
    # CPU-container benchmark sizes (same shape characteristics, small n —
    # the tee'd bench must finish in minutes on one CPU; the full-size
    # stand-ins above are exercised by tests/examples on demand)
    "dblp_bench": dict(kind="powerlaw", n=700, avg_deg=6, seed=1),
    "roadnet_bench": dict(kind="road", n=2304),
    "livejournal_bench": dict(kind="powerlaw", n=900, avg_deg=10, seed=2),
    "uk2002_bench": dict(kind="powerlaw", n=1100, avg_deg=14, seed=3),
}

# Query patterns, edge lists over vertices 0..k-1 (unlabeled, undirected,
# connected) — recreated at the paper's 3-6 vertex scale (Figure 7).
QUERIES: dict[str, list[tuple[int, int]]] = {
    "q1": [(0, 1), (1, 2), (0, 2)],                                   # triangle
    "q2": [(0, 1), (1, 2), (2, 3), (0, 3)],                           # square
    "q3": [(0, 1), (1, 2), (2, 3), (0, 3), (0, 2)],                   # diamond
    "q4": [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],           # 4-clique
    "q5": [(0, 1), (1, 2), (2, 3), (0, 3), (0, 2), (3, 4)],           # diamond+tail
    "q6": [(0, 1), (1, 2), (2, 3), (3, 4), (0, 4), (0, 2)],           # house
    "q7": [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (0, 5), (0, 3)],   # 6-cycle+chord
    "q8": [(0, 1), (0, 2), (0, 3), (1, 2), (3, 4), (3, 5)],           # tri + star
}

# clique-heavy set (Appendix C.4, Figure 14)
CLIQUE_QUERIES: dict[str, list[tuple[int, int]]] = {
    "qc1": [(0, 1), (0, 2), (1, 2), (2, 3), (3, 4), (2, 4)],          # two triangles
    "qc2": [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3), (3, 4)],  # 4clique+tail
    "qc3": [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3),
            (2, 4), (3, 4)],                                          # 4clique+tri
    "qc4": [(0, 1), (0, 2), (1, 2), (1, 3), (2, 3), (2, 4), (3, 4),
            (0, 4)],                                                  # dense 5v
}

DEFAULT_ENGINE = EngineConfig()
