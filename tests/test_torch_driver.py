"""End-to-end parity of the PyTorch port's ``rads_enumerate`` against the
JAX reference on one partition with the adjacency cache on (the default
main path): counts, embeddings and every non-timing stat; pipeline depth
1 and 2; the default device; configurations not ported yet; and the
port's import isolation from JAX."""
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


@pytest.mark.parametrize("kw,item", [(dict(storage_format="bucketed"), "6"),
                                     (dict(wire_format="varint"), "7")])
def test_unported_configurations_raise(setup, kw, item):
    tpg, _ = setup
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        port_run(tpg, "q1", **kw)
    with pytest.raises(NotImplementedError, match="item 8"):
        rads_enumerate(tpg, Pattern.from_edges(QUERIES["q1"]),
                       EngineConfig(**CAPS), mode="spmd", device="cpu")


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys; import repro_torch.core, repro_torch.convert, "
            "repro_torch.launch.enumerate, "
            "repro_torch.kernels.membership.kernel; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
