"""Host-side parity of the PyTorch port against the JAX reference:
generators, partitions, plans, plan tables, region groups and the oracle
are numpy code the port keeps its own copy of, and must stay identical."""
import numpy as np
import pytest

from repro.configs.rads import DATASETS, QUERIES
from repro.core.engine import build_plan_data as ref_build_plan_data
from repro.core.oracle import enumerate_oracle as ref_oracle
from repro.core.plan import best_plan as ref_best_plan
from repro.core.query import Pattern as RefPattern
from repro.core.region import iter_region_groups as ref_region_groups
from repro.graph import generators as ref_gen
from repro.graph.partition import partition as ref_partition

from repro_torch import convert
from repro_torch.core.engine import build_plan_data
from repro_torch.core.oracle import enumerate_oracle
from repro_torch.core.plan import best_plan
from repro_torch.core.query import Pattern
from repro_torch.core.region import iter_region_groups
from repro_torch.graph import generators as gen
from repro_torch.graph.partition import partition

PG_FIELDS = ("n", "n_real", "ndev", "stride", "max_degree", "adj", "deg",
             "n_local", "border", "border_dist", "old2new", "new2old")


def _same_csr(a, b):
    assert a.n == b.n
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)


@pytest.mark.parametrize("name", ["dblp_bench", "livejournal_bench",
                                  "uk2002_bench"])
def test_powerlaw_csr_identical(name):
    spec = dict(DATASETS[name])
    spec.pop("kind")
    _same_csr(ref_gen.powerlaw_graph(**spec), gen.powerlaw_graph(**spec))


@pytest.mark.parametrize("kind,kw", [("erdos", dict(n=120, avg_deg=5.0,
                                                    seed=5)),
                                     ("road", dict(n=400, seed=3))])
def test_other_generators_csr_identical(kind, kw):
    _same_csr(ref_gen.make_dataset(kind, **kw), gen.make_dataset(kind, **kw))


@pytest.mark.parametrize("method", ["bfs", "hash", "block"])
def test_partition_identical(method):
    rg = ref_gen.powerlaw_graph(700, 6, seed=1)
    ref = ref_partition(rg, 8, method=method)
    got = partition(gen.powerlaw_graph(700, 6, seed=1), 8, method=method)
    for f in PG_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      np.asarray(getattr(got, f)), err_msg=f)
    # the conversion the parity tests use carries every field over
    conv = convert.partitioned_from_arrays(
        {f: getattr(ref, f) for f in PG_FIELDS})
    for f in PG_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(conv, f)),
                                      np.asarray(getattr(got, f)), err_msg=f)


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_plan_and_plan_data_identical(q):
    ref_plan = ref_best_plan(RefPattern.from_edges(QUERIES[q]))
    plan = best_plan(Pattern.from_edges(QUERIES[q]))
    assert [(u.piv, u.leaves) for u in ref_plan.units] == \
        [(u.piv, u.leaves) for u in plan.units]
    assert ref_plan.matching_order == plan.matching_order
    assert repr(ref_build_plan_data(ref_plan)) == \
        repr(build_plan_data(plan))


def test_region_groups_and_oracle_identical():
    rg = ref_gen.erdos_graph(120, 5.0, seed=5)
    g = gen.erdos_graph(120, 5.0, seed=5)
    ref_pg, pg = ref_partition(rg, 8), partition(g, 8)
    for t in range(8):
        cands = np.arange(int(pg.n_local[t]), dtype=np.int64) + t * pg.stride
        est = np.linspace(1.0, 9.0, len(cands))
        ref = list(ref_region_groups(ref_pg, cands, est, 12.0, seed=t))
        got = list(iter_region_groups(pg, cands, est, 12.0, seed=t))
        assert len(ref) == len(got)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)
    for q in ("q1", "q2", "q6"):
        assert ref_oracle(rg, RefPattern.from_edges(QUERIES[q])) == \
            enumerate_oracle(g, Pattern.from_edges(QUERIES[q]))
