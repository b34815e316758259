"""The port's host modules of the paper's comparison against the
reference's, on the small graph of ``_torch_parity``: the baselines
(PSgL, the TwinTwig and SEED joins, Crystal-lite) give the reference's
counts, embeddings, shuffled bytes and peak rows, and their counts equal
the port's RADS count; the embedding trie built from RADS's embeddings
gives the reference's level sizes, removals and ``compression_report``."""
import numpy as np
import pytest

from repro.configs.rads import QUERIES
from repro.core import Pattern as RefPattern
from repro.core.baselines import crystal_lite as ref_crystal
from repro.core.baselines import join_enumerate as ref_join
from repro.core.baselines import psgl_enumerate as ref_psgl
from repro.core.trie import EmbeddingTrie as RefTrie
from repro.core.trie import compression_report as ref_report
from repro.graph import erdos_graph

from _torch_parity import port_run, small_partitions
from repro_torch.core import Pattern
from repro_torch.core.baselines import (build_triangle_index, crystal_lite,
                                        join_enumerate, psgl_enumerate)
from repro_torch.core.trie import (EmbeddingTrie, compression_report,
                                   embedding_list_bytes)
from repro_torch.graph import Graph

QUERY_NAMES = ("q1", "q2", "q5")


@pytest.fixture(scope="module")
def graphs():
    """(reference graph and partition, the port's copies, the port's
    RADS result per query)."""
    pg, tpg = small_partitions()
    g = erdos_graph(120, 5.0, seed=5)
    tg = Graph(n=g.n, indptr=np.array(g.indptr), indices=np.array(g.indices))
    rads = {q: port_run(tpg, q) for q in QUERY_NAMES}
    return g, pg, tg, tpg, rads


def _same(got, want):
    assert got.count == want.count
    assert got.embeddings == want.embeddings
    assert got.bytes_shuffled == want.bytes_shuffled
    assert got.peak_rows == want.peak_rows
    assert got.extra == want.extra


@pytest.mark.parametrize("q", QUERY_NAMES)
def test_baselines_match_reference_and_rads(graphs, q):
    g, pg, tg, tpg, rads = graphs
    pat, ref_pat = (Pattern.from_edges(QUERIES[q]),
                    RefPattern.from_edges(QUERIES[q]))
    tri = build_triangle_index(tg)
    runs = {
        "psgl": (psgl_enumerate(tpg, pat), ref_psgl(pg, ref_pat)),
        "twintwig": (join_enumerate(tpg, pat, "twintwig"),
                     ref_join(pg, ref_pat, "twintwig")),
        "seed": (join_enumerate(tpg, pat, "seed"),
                 ref_join(pg, ref_pat, "seed")),
        "crystal": (crystal_lite(tpg, pat, tg, tri_index=tri),
                    ref_crystal(pg, ref_pat, g))}
    for name, (got, want) in runs.items():
        _same(got, want)
        assert got.count == rads[q].count, name
    assert runs["psgl"][0].embeddings == rads[q].embeddings
    assert rads[q].count > 0


@pytest.mark.parametrize("q", QUERY_NAMES)
def test_trie_matches_reference(graphs, q):
    *_, rads = graphs
    rows = np.array(sorted(rads[q].embeddings), dtype=np.int32)
    assert compression_report(rows) == ref_report(rows)
    assert embedding_list_bytes(rows) == rows.size * 4
    t, rt = EmbeddingTrie.from_rows(rows), RefTrie.from_rows(rows)
    for lv, rlv in zip(t.levels, rt.levels):
        for f in ("vertex", "parent", "child_count", "alive"):
            np.testing.assert_array_equal(getattr(lv, f), getattr(rlv, f))
    np.testing.assert_array_equal(t.materialize(), rt.materialize())
    keep = np.arange(t.n_results) % 3 != 1
    t.filter_leaves(keep)
    rt.filter_leaves(keep)
    assert (t.nbytes, t.n_nodes, t.n_results) == (rt.nbytes, rt.n_nodes,
                                                  rt.n_results)
    np.testing.assert_array_equal(t.materialize(), rt.materialize())
