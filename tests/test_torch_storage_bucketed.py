"""The port's bucketed storage format against the reference's: the same
bucket caps, per-vertex maps and slab contents, the same ``adj_bytes``,
and adjacency windows byte-identical to the reference's and to the
dense format's for every vertex, with 1-D and 2-D indices."""
import numpy as np
import pytest
import torch

from repro.graph import erdos_graph, partition, powerlaw_graph
from repro.graph.storage import device_graph as ref_device_graph

from repro_torch import convert
from repro_torch.graph.storage import BucketedDeviceGraph, device_graph

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

PG_FIELDS = ("n", "n_real", "ndev", "stride", "max_degree", "adj", "deg",
             "n_local", "border", "border_dist", "old2new", "new2old")
GRAPHS = {
    # the skewed graph of tests/test_storage_formats.py
    "powerlaw": lambda: partition(powerlaw_graph(256, 8, seed=2), 4,
                                  method="bfs"),
    # windows padded past the real maximum degree: the flat buffer's tail
    "padded_max_degree": lambda: partition(powerlaw_graph(256, 8, seed=2),
                                           4, method="bfs", max_degree=80),
    # isolated vertices (degree 0) and device padding rows
    "erdos": lambda: partition(erdos_graph(120, 2.0, seed=3), 8,
                               method="hash"),
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graphs(request):
    pg = GRAPHS[request.param]()
    tpg = convert.partitioned_from_arrays({f: getattr(pg, f)
                                           for f in PG_FIELDS})
    return (pg, ref_device_graph(pg, "bucketed"),
            device_graph(tpg, "bucketed", device="cpu"),
            device_graph(tpg, "dense", device="cpu"))


def test_layout_and_bytes_match_reference(graphs):
    _, ref, got, _ = graphs
    assert isinstance(got, BucketedDeviceGraph)
    assert got.bucket_caps == ref.bucket_caps
    for name in ("deg", "bucket_of", "slot_of"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert len(got.slabs) == len(ref.slabs)
    for a, b in zip(got.slabs, ref.slabs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tail = max(0, got.max_degree - got.bucket_caps[-1])
    assert got.adj_bytes == ref.adj_bytes + 4 * got.ndev * tail


def test_rows_match_reference_and_dense(graphs):
    pg, ref, got, dense = graphs
    li = torch.arange(pg.stride, dtype=torch.int32)
    rows = got.rows_at(li.expand(pg.ndev, -1).contiguous())
    np.testing.assert_array_equal(rows.numpy(), dense.rows_at(
        li.expand(pg.ndev, -1).contiguous()).numpy())
    for t in range(pg.ndev):
        np.testing.assert_array_equal(
            rows[t].numpy(), np.asarray(ref.rows_at(t, np.arange(pg.stride))))
        np.testing.assert_array_equal(
            got.deg_at(li[None], t)[0].numpy(),
            np.asarray(ref.deg_at(t, np.arange(pg.stride))))


def test_rows_2d_index_and_device_offset(graphs):
    """A 2-D block of indices per device (the exchange answers gather
    such blocks), starting at a device other than 0."""
    pg, ref, got, dense = graphs
    rng = np.random.default_rng(0)
    li = rng.integers(0, pg.stride, (pg.ndev - 1, 3, 5)).astype(np.int32)
    out = got.rows_at(torch.as_tensor(li), 1)
    np.testing.assert_array_equal(
        out.numpy(), dense.rows_at(torch.as_tensor(li), 1).numpy())
    for i in range(pg.ndev - 1):
        np.testing.assert_array_equal(out[i].numpy(),
                                      np.asarray(ref.rows_at(i + 1, li[i])))
