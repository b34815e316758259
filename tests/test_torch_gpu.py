"""Card-only tests of the PyTorch port: the hand-written CUDA kernel
against its plain PyTorch version, and the whole engine on the card
against the port's CPU path.  They skip without a CUDA card, and import
no JAX, so they run where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py``."""
import pytest
import torch

from _membership_cases import CASES, edge_inputs, sweep_inputs
from repro_torch.configs.rads import QUERIES, EngineConfig
from repro_torch.core import Pattern, rads_enumerate
from repro_torch.graph import erdos_graph, partition
from repro_torch.kernels.membership import ops
from repro_torch.kernels.membership.ref import membership_ref

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
@pytest.mark.parametrize("q", ["q1", "q2", "q6"])
def test_engine_on_card_matches_cpu(cuda, q):
    pg = partition(erdos_graph(120, 5.0, seed=5), 8, method="bfs")
    pat = Pattern.from_edges(QUERIES[q])
    before = ops.launches
    got = rads_enumerate(pg, pat, EngineConfig(**CAPS), device=cuda)
    assert ops.launches > before
    want = rads_enumerate(pg, pat, EngineConfig(**CAPS), device="cpu")
    assert got.count == want.count and got.embeddings == want.embeddings
    for k in set(want.stats) - TIMING_KEYS:
        assert got.stats[k] == want.stats[k], k
