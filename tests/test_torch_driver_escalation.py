"""End-to-end parity of the PyTorch port's ``rads_enumerate`` against the
JAX reference through overflow splits and capacity escalations with the
varint wire: the config of ``tests/test_wire.py::
test_wire_escalation_survival`` (the coded stream caps escalate with the
engine caps), for both storage formats."""
import pytest

from _torch_parity import PG_FIELDS, as_format, assert_same_result
from repro.configs.rads import QUERIES, EngineConfig as RefConfig
from repro.core import Pattern as RefPattern
from repro.core import rads_enumerate as ref_enumerate
from repro.graph import partition, powerlaw_graph

from repro_torch import convert
from repro_torch.configs.rads import EngineConfig
from repro_torch.core import Pattern, rads_enumerate

KW = dict(frontier_cap=512, fetch_cap=128, verify_cap=512,
          region_group_budget=256, enable_sme=False, cache_slots=256,
          wire_format="varint")


@pytest.fixture(scope="module")
def setup():
    pg = partition(powerlaw_graph(128, 6, seed=2), 4, method="hash")
    tpg = convert.partitioned_from_arrays({f: getattr(pg, f)
                                           for f in PG_FIELDS})
    ref = ref_enumerate(pg, RefPattern.from_edges(QUERIES["q3"]),
                        RefConfig(**KW, prewarm=False,
                                  storage_format="bucketed"))
    return pg, tpg, ref


@pytest.mark.parametrize("fmt", ["dense", "bucketed"])
def test_escalating_varint_run_matches_reference(setup, fmt):
    pg, tpg, ref = setup
    got = rads_enumerate(tpg, Pattern.from_edges(QUERIES["q3"]),
                         EngineConfig(**KW, storage_format=fmt),
                         device="cpu")
    assert_same_result(got, as_format(ref, pg, fmt))
    st = got.stats
    assert st["cap_escalations"] >= 1 and st["overflow_retries"] >= 1
    assert st["bytes_wire_verify"] < st["bytes_verify"]
    assert st["bytes_wire_fetch"] <= st["bytes_fetch"]
