"""Shared inputs of the PyTorch port's parity tests: one partition of the
small erdos graph, handed to both packages, and the reference's results."""
import types

import torch

from repro.configs.rads import QUERIES, EngineConfig as RefConfig
from repro.core import Pattern as RefPattern
from repro.core import rads_enumerate as ref_enumerate
from repro.graph import erdos_graph, partition
from repro.graph.storage import device_graph as ref_device_graph

from repro_torch import convert
from repro_torch.configs.rads import EngineConfig
from repro_torch.core import Pattern, rads_enumerate

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

# the verify recipe's caps (small graph, several waves, no escalation)
CAPS = dict(frontier_cap=1 << 12, fetch_cap=256, verify_cap=1024,
            region_group_budget=1 << 11)
PG_FIELDS = ("n", "n_real", "ndev", "stride", "max_degree", "adj", "deg",
             "n_local", "border", "border_dist", "old2new", "new2old")
# wall-clock and compile accounting: the CPU runs eagerly (compiles=0)
TIMING_KEYS = {"compiles", "compile_s", "compile_cache_hits", "wave_s_total",
               "sme_wall_us", "dist_wall_us", "wall_us", "sme_pipeline_s",
               "dist_pipeline_s"}
QS = ("q1", "q2", "q6")


def small_partitions():
    """(reference PartitionedGraph, the port's copy of it)."""
    pg = partition(erdos_graph(120, 5.0, seed=5), 8, method="bfs")
    return pg, convert.partitioned_from_arrays(
        {f: getattr(pg, f) for f in PG_FIELDS})


def reference_run(pg, q, **kw):
    # no background pre-warm: it compiles stages this run never uses
    return ref_enumerate(pg, RefPattern.from_edges(QUERIES[q]),
                         RefConfig(**CAPS, prewarm=False, **kw))


def port_run(tpg, q, **kw):
    return rads_enumerate(tpg, Pattern.from_edges(QUERIES[q]),
                          EngineConfig(**CAPS, **kw), device="cpu")


def assert_same_result(got, want):
    """Counts, embeddings and every non-timing stat equal."""
    assert got.count == want.count
    assert got.embeddings == want.embeddings
    assert set(got.stats) == set(want.stats)
    for k in set(want.stats) - TIMING_KEYS:
        assert got.stats[k] == want.stats[k], k
    assert got.stats["compiles"] == 0 and got.stats["compile_s"] == 0.0
    assert got.stats["exec_cache_enabled"] is False


# the caps of tests/test_storage_formats.py
STORAGE_CAPS = dict(frontier_cap=1 << 13, fetch_cap=512, verify_cap=2048,
                    region_group_budget=1 << 12)


def storage_reference_run(pg, q, **kw):
    """The reference at the storage-format caps, with bucketed storage."""
    return ref_enumerate(pg, RefPattern.from_edges(QUERIES[q]),
                         RefConfig(**STORAGE_CAPS, prewarm=False,
                                   storage_format="bucketed", **kw))


def storage_port_run(tpg, q, **kw):
    return rads_enumerate(tpg, Pattern.from_edges(QUERIES[q]),
                          EngineConfig(**STORAGE_CAPS, **kw), device="cpu")


def as_format(ref, pg, fmt):
    """The reference's result with the stats of storage format ``fmt``.

    Its results do not depend on the storage format (its own
    ``test_backend_parity_powerlaw``) except for ``storage_format`` and
    ``peak_adj_bytes``, which are set to the reference's values for
    ``fmt``."""
    stats = dict(ref.stats, storage_format=fmt,
                 peak_adj_bytes=int(ref_device_graph(pg, fmt).adj_bytes))
    return types.SimpleNamespace(count=ref.count, embeddings=ref.embeddings,
                                 stats=stats)
