"""Card-only tests of the PyTorch port: the hand-written CUDA kernels
(membership, intersect, delta_vlen) against their plain PyTorch
versions, and the whole engine on the card — dense and bucketed storage,
raw and varint wire — against the port's CPU path.  They skip without a
CUDA card, and import no JAX, so they run where only PyTorch is
installed:
``PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py``."""
import pytest
import torch

from _codec_cases import (DELTA_VLEN_SWEEP, INTERSECT_CASES,
                          delta_vlen_inputs, intersect_inputs)
from _membership_cases import CASES, edge_inputs, sweep_inputs
from repro_torch.configs.rads import QUERIES, EngineConfig
from repro_torch.core import Pattern, rads_enumerate
from repro_torch.graph import erdos_graph, partition
from repro_torch.kernels.intersect import ops as intersect_ops
from repro_torch.kernels.intersect.ref import intersect_ref
from repro_torch.kernels.membership import ops
from repro_torch.kernels.membership.ref import membership_ref
from repro_torch.kernels.varint import ops as varint_ops
from repro_torch.kernels.varint.ref import delta_vlen_ref

CAPS = dict(frontier_cap=1 << 12, fetch_cap=256, verify_cap=1024,
            region_group_budget=1 << 11)
TIMING_KEYS = {"wave_s_total", "sme_wall_us", "dist_wall_us", "wall_us",
               "sme_pipeline_s", "dist_pipeline_s"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind,arg", CASES)
def test_kernel_matches_plain_on_card(cuda, kind, arg):
    rows, vals = sweep_inputs(*arg) if kind == "sweep" else edge_inputs(arg)
    rows = torch.as_tensor(rows, device=cuda)
    vals = torch.as_tensor(vals, device=cuda)
    before = ops.launches
    got = ops.membership(rows, vals)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert torch.equal(got, membership_ref(rows, vals))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,shape", INTERSECT_CASES)
def test_intersect_kernel_matches_plain_on_card(cuda, kind, shape):
    a, b, sent = intersect_inputs(kind, *shape)
    a = torch.as_tensor(a, device=cuda)
    b = torch.as_tensor(b, device=cuda)
    before = intersect_ops.launches
    mask, count = intersect_ops.intersect(a, b, sent)
    torch.cuda.synchronize()
    assert intersect_ops.launches == before + 1
    want_mask, want_count = intersect_ref(a, b, sent)
    assert torch.equal(mask, want_mask) and torch.equal(count, want_count)


@pytest.mark.gpu
@pytest.mark.parametrize("B,M", DELTA_VLEN_SWEEP + [(5, 4099)])
def test_delta_vlen_kernel_matches_plain_on_card(cuda, B, M):
    ids, n = delta_vlen_inputs(B, M)
    ids = torch.as_tensor(ids, device=cuda)
    before = varint_ops.launches
    delta, vlen = varint_ops.delta_vlen(ids, n)
    torch.cuda.synchronize()
    assert varint_ops.launches == before + 1
    want_delta, want_vlen = delta_vlen_ref(ids, n)
    assert torch.equal(delta, want_delta) and torch.equal(vlen, want_vlen)


def _launch_counts():
    return (ops.launches, intersect_ops.launches, varint_ops.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("q,fmt,wire", [("q1", "dense", "raw"),
                                        ("q2", "dense", "raw"),
                                        ("q6", "dense", "raw"),
                                        ("q1", "bucketed", "varint"),
                                        ("q3", "bucketed", "raw"),
                                        ("q6", "dense", "varint")])
def test_engine_on_card_matches_cpu(cuda, q, fmt, wire):
    pg = partition(erdos_graph(120, 5.0, seed=5), 8, method="bfs")
    pat = Pattern.from_edges(QUERIES[q])
    cfg = EngineConfig(**CAPS, storage_format=fmt, wire_format=wire)
    before = _launch_counts()
    got = rads_enumerate(pg, pat, cfg, device=cuda)
    after = _launch_counts()
    assert after[0] > before[0]
    if fmt == "bucketed":
        assert after[1] > before[1]
    if wire == "varint":
        assert after[2] > before[2]
    want = rads_enumerate(pg, pat, cfg, device="cpu")
    assert got.count == want.count and got.embeddings == want.embeddings
    for k in set(want.stats) - TIMING_KEYS:
        assert got.stats[k] == want.stats[k], k
