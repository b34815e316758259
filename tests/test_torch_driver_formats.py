"""End-to-end parity of the PyTorch port's ``rads_enumerate`` against the
JAX reference across storage formats and wire formats: {dense, bucketed}
× {raw, varint} × cache on/off on q1 over the skewed graph of
``tests/test_storage_formats.py`` at its caps — counts, embeddings and
every non-timing stat.  (q3 is in ``test_torch_driver_q3.py``, the
escalating case in ``test_torch_driver_escalation.py``.)

The reference runs with the bucketed format; the port's dense runs are
held against the same run with the format stats set to the reference's
dense values (``_torch_parity.as_format``)."""
import itertools

import pytest

from _torch_parity import (PG_FIELDS, as_format, assert_same_result,
                           storage_port_run, storage_reference_run)
from repro.graph import partition, powerlaw_graph

from repro_torch import convert

MATRIX = list(itertools.product(("dense", "bucketed"), ("raw", "varint"),
                                (True, False)))


@pytest.fixture(scope="module")
def skewed():
    pg = partition(powerlaw_graph(256, 8, seed=2), 4, method="bfs")
    tpg = convert.partitioned_from_arrays({f: getattr(pg, f)
                                           for f in PG_FIELDS})
    ref = {(w, c): storage_reference_run(pg, "q1", wire_format=w,
                                         enable_cache=c)
           for w in ("raw", "varint") for c in (True, False)}
    return pg, tpg, ref


@pytest.mark.parametrize("fmt,wire,cache", MATRIX)
def test_q1_matches_reference(skewed, fmt, wire, cache):
    pg, tpg, ref = skewed
    got = storage_port_run(tpg, "q1", storage_format=fmt,
                           wire_format=wire, enable_cache=cache)
    assert_same_result(got, as_format(ref[wire, cache], pg, fmt))
    st = got.stats
    assert st["storage_format"] == fmt and st["wire_format"] == wire
    if wire == "varint":
        assert st["bytes_wire_verify"] < st["bytes_verify"]
        assert st["bytes_wire_fetch"] <= st["bytes_fetch"]


def test_bucketed_holds_less_adjacency(skewed):
    """On the skewed graph the bucketed slabs take under half of the
    dense adjacency (the reference asks a quarter at n = 4,096)."""
    _, tpg, _ = skewed
    st = {f: storage_port_run(tpg, "q1", storage_format=f)
          .stats["peak_adj_bytes"] for f in ("dense", "bucketed")}
    assert st["bucketed"] * 2 <= st["dense"], st


def test_varint_sync_equals_pipelined(skewed):
    _, tpg, _ = skewed
    kw = dict(storage_format="bucketed", wire_format="varint")
    d1 = storage_port_run(tpg, "q1", pipeline_depth=1, **kw)
    d2 = storage_port_run(tpg, "q1", pipeline_depth=2, **kw)
    assert d1.count == d2.count and d1.embeddings == d2.embeddings
    for k in ("bytes_fetch", "bytes_verify", "bytes_wire_fetch",
              "bytes_wire_verify", "bytes_saved_cache"):
        assert d1.stats[k] == d2.stats[k], k
