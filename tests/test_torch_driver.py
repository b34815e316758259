"""End-to-end parity of the PyTorch port's ``rads_enumerate`` against the
JAX reference on one partition with the adjacency cache on (the default
main path): counts, embeddings and every non-timing stat; pipeline depth
1 and 2; the default device; the multi-process exchange backends without
a process group; and the port's import isolation from JAX."""
import os
import subprocess
import sys

import pytest
import torch

from _torch_parity import (CAPS, QS, TIMING_KEYS, assert_same_result,
                           port_run, reference_run, small_partitions)
from repro.configs.rads import QUERIES

from repro_torch.configs.rads import EngineConfig
from repro_torch.core import Pattern, rads_enumerate

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def setup():
    pg, tpg = small_partitions()
    return tpg, {q: reference_run(pg, q, enable_cache=True) for q in QS}


@pytest.mark.parametrize("q", QS)
def test_rads_enumerate_matches_reference_cache_on(setup, q):
    tpg, ref = setup
    assert_same_result(port_run(tpg, q, enable_cache=True), ref[q])


@pytest.mark.parametrize("q", QS)
def test_depth_1_equals_depth_2(setup, q):
    tpg, _ = setup
    d1 = port_run(tpg, q, pipeline_depth=1)
    d2 = port_run(tpg, q, pipeline_depth=2)
    assert d1.count == d2.count and d1.embeddings == d2.embeddings
    for k in set(d1.stats) - TIMING_KEYS - {"pipeline_depth",
                                            "max_inflight_waves"}:
        assert d1.stats[k] == d2.stats[k], k


def test_default_device_is_cuda(setup):
    tpg, _ = setup
    pat = Pattern.from_edges(QUERIES["q1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            rads_enumerate(tpg, pat, EngineConfig(**CAPS))
        return
    got = rads_enumerate(tpg, pat, EngineConfig(**CAPS))
    assert got.embeddings == port_run(tpg, "q1").embeddings


@pytest.mark.parametrize("mode,wire", [("spmd", "raw"), ("dist", "varint")])
def test_multiprocess_modes_need_a_process_group(setup, mode, wire):
    """``spmd``/``dist`` run one rank per partition: without an
    initialized ``torch.distributed`` process group they refuse to run."""
    tpg, _ = setup
    pat = Pattern.from_edges(QUERIES["q1"])
    with pytest.raises(ValueError, match="process group"):
        rads_enumerate(tpg, pat, EngineConfig(**CAPS, wire_format=wire),
                       mode=mode, device="cpu")


def test_wire_auto_two_runs_match_reference(tmp_path):
    """``wire_format="auto"`` with a priors file per package: run 0 takes
    the heuristic (raw, in ``sim``), run 1 explores the other codec
    (varint).  Neither reads a wall time, so each run equals the
    reference's, wire bytes included.  (Run 2 would compare the two
    recorded wall times: it may differ between runs of either package.)"""
    pg, tpg = small_partitions()
    for run, (fmt, reason) in enumerate((("raw", "heuristic"),
                                         ("varint", "explore"))):
        want = reference_run(pg, "q1", wire_format="auto",
                             priors_path=str(tmp_path / "ref.json"))
        got = port_run(tpg, "q1", wire_format="auto",
                       priors_path=str(tmp_path / "port.json"))
        assert_same_result(got, want)
        assert (got.stats["wire_format"], got.stats["wire_auto_reason"]) \
            == (fmt, reason), run


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys; import repro_torch.core, repro_torch.convert, "
            "repro_torch.launch.enumerate, "
            "repro_torch.kernels.membership.kernel, "
            "repro_torch.kernels.intersect.kernel, "
            "repro_torch.kernels.varint.kernel, repro_torch.core.wire, "
            "repro_torch.models, repro_torch.configs, "
            "repro_torch.configs.olmoe_1b_7b, repro_torch.configs.qwen15_05b, "
            "repro_torch.configs.qwen3_4b, repro_torch.configs.qwen3_14b, "
            "repro_torch.distributed.ctx, "
            "repro_torch.kernels.flash_attn.ops, "
            "repro_torch.kernels.flash_attn.kernel, "
            "repro_torch.kernels.moe_gemm.ops, "
            "repro_torch.kernels.moe_gemm.kernel, "
            "repro_torch.models.gnn, repro_torch.configs.gat_cora, "
            "repro_torch.models.recsys, repro_torch.configs.din, "
            "repro_torch.configs.graphcast, repro_torch.configs.schnet, "
            "repro_torch.configs.pna, "
            "repro_torch.kernels.segment_spmm.ops, "
            "repro_torch.kernels.segment_spmm.kernel, "
            "repro_torch.optim, repro_torch.data, repro_torch.checkpoint, "
            "repro_torch.runtime, repro_torch.runtime.compile_cache, "
            "repro_torch.distributed.compression, "
            "repro_torch.launch.train, repro_torch.launch.dist_worker, "
            "repro_torch.core.exchange, repro_torch.graph.partition, "
            "repro_torch.launch.mesh, repro_torch.launch.specs, "
            "repro_torch.launch.dryrun, repro_torch.distributed.sharding; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
