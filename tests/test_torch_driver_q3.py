"""End-to-end parity of the PyTorch port's ``rads_enumerate`` against the
JAX reference on q3 (the diamond) with the varint wire, on the small
graph at the caps of ``tests/test_storage_formats.py``, for both storage
formats."""
import pytest

from _torch_parity import (as_format, assert_same_result, small_partitions,
                           storage_port_run, storage_reference_run)


@pytest.fixture(scope="module")
def setup():
    pg, tpg = small_partitions()
    return pg, tpg, storage_reference_run(pg, "q3", wire_format="varint")


@pytest.mark.parametrize("fmt", ["dense", "bucketed"])
def test_q3_varint_matches_reference(setup, fmt):
    pg, tpg, ref = setup
    got = storage_port_run(tpg, "q3", storage_format=fmt, wire_format="varint")
    assert_same_result(got, as_format(ref, pg, fmt))
    assert got.stats["bytes_wire_verify"] < got.stats["bytes_verify"]
