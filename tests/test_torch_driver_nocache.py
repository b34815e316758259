"""End-to-end parity of the PyTorch port's ``rads_enumerate`` against the
JAX reference with the adjacency cache off, and the cache's byte
conservation: ``bytes_fetch(on) + bytes_saved_cache == bytes_fetch(off)``
with identical results."""
import pytest

from _torch_parity import (QS, assert_same_result, port_run, reference_run,
                           small_partitions)


@pytest.fixture(scope="module")
def setup():
    pg, tpg = small_partitions()
    return tpg, {q: reference_run(pg, q, enable_cache=False) for q in QS}


@pytest.mark.parametrize("q", QS)
def test_rads_enumerate_matches_reference_cache_off(setup, q):
    tpg, ref = setup
    got = port_run(tpg, q, enable_cache=False)
    assert_same_result(got, ref[q])
    assert got.stats["cache_hits"] == got.stats["cache_probes"] == 0.0


@pytest.mark.parametrize("q", QS)
def test_cache_conserves_fetch_bytes(setup, q):
    tpg, ref = setup
    on = port_run(tpg, q, enable_cache=True)
    off = ref[q].stats
    assert on.count == ref[q].count and on.embeddings == ref[q].embeddings
    assert on.stats["bytes_fetch"] + on.stats["bytes_saved_cache"] \
        == off["bytes_fetch"]
