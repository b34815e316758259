"""Engine-level parity of the PyTorch port against the JAX reference: the
static-shape primitives, the adjacency cache state after every batch of a
multi-batch sequence, and the whole ``run_rounds`` tuple (every stats
field included) in SM-E and distributed modes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.rads import QUERIES, EngineConfig as RefConfig
from repro.core import engine as ref_engine
from repro.core import exchange as ref_exchange
from repro.core.cache import AdjCache as RefCache, build_cache as ref_cache
from repro.core.cache import probe_dev as ref_probe
from repro.core.plan import best_plan as ref_best_plan
from repro.core.query import Pattern as RefPattern
from repro.graph import erdos_graph, partition
from repro.graph.storage import device_graph as ref_device_graph

from repro_torch import convert
from repro_torch.configs.rads import EngineConfig
from repro_torch.core import engine, exchange
from repro_torch.core.cache import build_cache, probe_dev
from repro_torch.core.plan import best_plan
from repro_torch.core.query import Pattern
from repro_torch.graph.storage import device_graph

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

PG_FIELDS = ("n", "n_real", "ndev", "stride", "max_degree", "adj", "deg",
             "n_local", "border", "border_dist", "old2new", "new2old")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b, msg=""):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (msg, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=msg)


@pytest.mark.parametrize("n,cap,density", [(37, 16, 0.3), (37, 50, 0.7),
                                           (64, 64, 1.0), (20, 8, 0.0)])
def test_compact_matches_reference(n, cap, density):
    rng = np.random.default_rng(n * cap)
    mask = rng.random((3, n)) < density
    vals = rng.integers(0, 1000, (3, n)).astype(np.int32)
    pay = rng.integers(0, 9, (3, n, 4)).astype(np.int32)
    ref = jax.vmap(lambda m, v, p: ref_exchange.compact(
        m, cap, v, p, fills=(-1, 7)))(jnp.asarray(mask), jnp.asarray(vals),
                                       jnp.asarray(pay))
    got = exchange.compact(torch.as_tensor(mask), cap, torch.as_tensor(vals),
                           torch.as_tensor(pay), fills=(-1, 7))
    for r, g, name in zip(ref, got, ("mask", "overflow", "vals", "pay")):
        _eq(g, r, name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unique_ids_and_pairs_match_reference(seed):
    rng = np.random.default_rng(seed)
    sent = 40
    ids = rng.integers(0, sent + 1, (4, 60)).astype(np.int32)
    mask = rng.random((4, 60)) < 0.8
    ref = jax.vmap(lambda i, m: ref_exchange.unique_ids(i, m, sent))(
        jnp.asarray(ids), jnp.asarray(mask))
    got = exchange.unique_ids(torch.as_tensor(ids), torch.as_tensor(mask),
                              sent)
    for r, g in zip(ref, got):
        _eq(g, r, "unique_ids")
    # duplicate-heavy pairs over a small alphabet
    a = rng.integers(0, 6, (4, 60)).astype(np.int32)
    b = rng.integers(0, 6, (4, 60)).astype(np.int32)
    ref = jax.vmap(lambda x, y, m: ref_exchange.unique_pairs(x, y, m, sent))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))
    got = exchange.unique_pairs(torch.as_tensor(a), torch.as_tensor(b),
                                torch.as_tensor(mask), sent)
    for r, g, name in zip(ref, got, ("ua", "ub", "umask", "rank")):
        _eq(g, r, name)


@pytest.mark.parametrize("decay,ways", [(0, 2), (3, 1), (2, 4)])
def test_cache_state_matches_reference_after_every_batch(decay, ways):
    rng = np.random.default_rng(decay * 10 + ways)
    ndev, slots, width, n, m = 3, 8, 5, 50, 12
    keys = np.where(rng.random((ndev, slots, ways)) < 0.5,
                    rng.integers(0, n, (ndev, slots, ways)), n)
    benefit = np.where(keys < n, rng.integers(-3, 9, keys.shape), -(1 << 20))
    table = np.sort(rng.integers(0, n + 1, (n + 1, width)), axis=1)
    table[n] = n
    state = dict(keys=keys.astype(np.int32),
                 rows=table[keys].astype(np.int32),
                 benefit=benefit.astype(np.int32),
                 tick=np.zeros(ndev, np.int32), n=n)
    ref = RefCache(ndev=ndev, slots=slots, ways=ways, n=n, line_width=width,
                   decay=decay, **{k: jnp.asarray(state[k]) for k in
                                   ("keys", "rows", "benefit", "tick")})
    got = convert.cache_from_arrays(state, device="cpu", decay=decay)
    for step in range(6):
        # per-device unique request ids (sentinel holes), as fetchV sends
        ids = np.stack([np.where(rng.random(m) < 0.8,
                                 rng.choice(n, m, replace=False), n)
                        for _ in range(ndev)]).astype(np.int32)
        r_hit, r_way, r_row = jax.vmap(
            lambda k, r, i: ref_probe(k, r, i, n))(ref.keys, ref.rows,
                                                   jnp.asarray(ids))
        hit, way, row = probe_dev(got.keys, got.rows, torch.as_tensor(ids), n)
        for r, g, name in ((r_hit, hit, "hit"), (r_way, way, "way"),
                           (r_row, row, "row")):
            _eq(g, r, f"step {step} {name}")
        frows = np.where(_np(hit)[..., None], _np(row), table[ids])
        ref = ref.updated(jnp.asarray(ids), r_hit, r_way,
                          jnp.asarray(frows.astype(np.int32)))
        got = got.updated(torch.as_tensor(ids), hit, way,
                          torch.as_tensor(frows.astype(np.int32)))
        for name in ("keys", "rows", "benefit", "tick"):
            _eq(getattr(got, name), getattr(ref, name), f"step {step} {name}")


@pytest.fixture(scope="module")
def graphs():
    pg = partition(erdos_graph(120, 5.0, seed=5), 8, method="bfs")
    tpg = convert.partitioned_from_arrays({f: getattr(pg, f)
                                           for f in PG_FIELDS})
    return ref_device_graph(pg, "dense"), device_graph(tpg, device="cpu"), pg


@pytest.mark.parametrize("local_only", [True, False])
@pytest.mark.parametrize("q", ["q1", "q2", "q6"])
def test_run_rounds_tuple_matches_reference(graphs, q, local_only):
    ref_g, g, pg = graphs
    kw = dict(frontier_cap=1 << 8, fetch_cap=32, verify_cap=64,
              cache_slots=8)
    rng = np.random.default_rng(0)
    seeds = np.full((8, 8), pg.n, np.int32)
    mask = np.zeros((8, 8), bool)
    for t in range(8):
        k = int(pg.n_local[t])
        s = rng.choice(k, size=min(8, k), replace=False) + t * pg.stride
        seeds[t, :len(s)] = s
        mask[t, :len(s)] = True
    ref_cfg, cfg = RefConfig(**kw), EngineConfig(**kw)
    ref_pd = ref_engine.build_plan_data(
        ref_best_plan(RefPattern.from_edges(QUERIES[q])))
    # jitted as the reference's scheduler runs it (and faster to compile
    # than op-by-op dispatch)
    ref = jax.jit(lambda gg, s, m, c: ref_engine.run_rounds(
        gg, ref_pd, ref_cfg, ref_exchange.Exchange("sim"), s, m, local_only,
        c))(ref_g, jnp.asarray(seeds), jnp.asarray(mask),
            ref_cache(ref_cfg, ref_g))
    got = engine.run_rounds(
        g, engine.build_plan_data(best_plan(Pattern.from_edges(QUERIES[q]))),
        cfg, exchange.Exchange("sim"), seeds, mask, local_only,
        build_cache(cfg, g))
    for name, r, o in zip(("rows", "alive", "counts", "complete"),
                          ref[:4], got[:4]):
        _eq(o, r, name)
    ref_st, st = ref[4], got[4]
    assert set(ref_st) == set(st)
    for k in ref_st:
        _eq(st[k], ref_st[k], k)


@pytest.mark.parametrize("local_only", [True, False])
def test_device_chunking_does_not_change_results(graphs, monkeypatch,
                                                 local_only):
    """Memory-bounded chunks over devices (one device per chunk here) give
    the same tuple as one chunk for the whole stack."""
    _, g, pg = graphs
    cfg = EngineConfig(frontier_cap=1 << 8, fetch_cap=32, verify_cap=64,
                       cache_slots=8)
    pd = engine.build_plan_data(best_plan(Pattern.from_edges(QUERIES["q2"])))
    seeds = (np.arange(8)[:, None] * pg.stride
             + np.arange(4)[None, :]).astype(np.int32)
    mask = np.ones((8, 4), bool)

    def run():
        return engine.run_rounds(g, pd, cfg, exchange.Exchange("sim"), seeds,
                                 mask, local_only, build_cache(cfg, g))
    whole = run()
    monkeypatch.setattr(engine, "CHUNK_ELEMS", 1)
    chunked = run()
    for a, b in zip(whole[:4], chunked[:4]):
        _eq(b, a)
    for k in whole[4]:
        _eq(chunked[4][k], whole[4][k], k)
