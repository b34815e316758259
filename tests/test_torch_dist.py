"""The port's exchange backends beyond ``sim`` against the JAX reference:
the registry, ``gather`` bit for bit against ``sim`` and the reference's
``gather``, the rank-local device graph, ``merge_process_stats``, and
``dist`` as real processes over ``torch.distributed`` (gloo): the
``dist_worker`` launcher on two processes against ``sim``, and two
spawned ranks of ``rads_enumerate`` against the reference's embeddings
and stats."""
import concurrent.futures
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _dist_rank import run_spawned
from _torch_parity import (CAPS, PG_FIELDS, QS, TIMING_KEYS,
                           assert_same_result, small_partitions)
from repro.configs.rads import QUERIES, EngineConfig as RefConfig
from repro.core import Pattern as RefPattern
from repro.core import rads_enumerate as ref_enumerate
from repro.core.driver import merge_process_stats as ref_merge
from repro.core.exchange import Exchange as RefExchange
from repro.graph import erdos_graph, load_dataset as ref_load_dataset
from repro.graph import partition as ref_partition

from repro_torch import convert
from repro_torch.configs.rads import EngineConfig
from repro_torch.core import (Exchange, Pattern, exchange_backends,
                              merge_process_stats, rads_enumerate)
from repro_torch.core.cache import AdjCache
from repro_torch.core.scheduler import pack_result, unpack_gathered
from repro_torch.graph import (device_graph, load_dataset, partition,
                               partition_device)
from repro_torch.graph import erdos_graph as torch_erdos_graph
from repro_torch.launch.dist_worker import (build_argparser, launch_local,
                                            worker_config)

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

# the caps of the reference's two-process gate
# (tests/test_multidevice.py::test_dist_two_process_matches_sim)
DIST_CAPS = ["--frontier-cap", str(1 << 12), "--fetch-cap", str(1 << 9),
             "--verify-cap", str(1 << 11), "--region-budget", str(1 << 11)]
DIST_CASES = [("raw", True), ("raw", False), ("varint", True),
              ("varint", False)]
# host-local or topology stats: a rank's own, not the logical result
RANK_KEYS = TIMING_KEYS | {"process_index", "process_count"}


def _jsonable(stats: dict) -> dict:
    """A stats dict as a worker's JSON payload carries it."""
    return json.loads(json.dumps(stats, default=float))


def _assert_stats_equal(got: dict, want: dict, skip=RANK_KEYS):
    got, want = _jsonable(got), _jsonable(want)
    assert set(got) == set(want)
    for k in set(want) - skip:
        assert got[k] == want[k], k


# --------------------------------------------------------------------------- #
# Registry and the gather backend
# --------------------------------------------------------------------------- #
def test_exchange_registry_and_unknown_mode():
    assert {"sim", "gather", "spmd", "dist"} <= set(exchange_backends())
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="unknown exchange mode"):
        Exchange("no-such-backend")
    for mode in ("spmd", "dist"):
        with pytest.raises(ValueError, match="process group"):
            Exchange(mode)
    with pytest.raises(ValueError, match="comm_chunks"):
        Exchange("gather", comm_chunks=0)
    with pytest.raises(ValueError, match="wire format"):
        Exchange("gather", wire_format="zstd")


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_gather_exchange_matches_sim_and_reference(chunks):
    rng = np.random.default_rng(chunks)
    x = rng.integers(0, 1 << 20, (4, 4, 8, 3)).astype(np.int32)
    lens = rng.integers(0, 99, (4, 4)).astype(np.int32)
    flags = rng.random((4, 4, 8)) < 0.5
    vals = rng.standard_normal((4, 5)).astype(np.float32)
    gat = Exchange("gather", comm_chunks=chunks)
    sim = Exchange("sim", comm_chunks=chunks)
    ref = RefExchange("gather", comm_chunks=chunks)
    for a in (x, lens, flags):
        got = gat.a2a(torch.from_numpy(a))
        np.testing.assert_array_equal(got.numpy(),
                                      sim.a2a(torch.from_numpy(a)).numpy())
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref.a2a(jnp.asarray(a))))
    got = gat.a2a_tree((torch.from_numpy(x), torch.from_numpy(lens)))
    np.testing.assert_array_equal(got[1].numpy(), lens.T)
    s = gat.all_reduce_sum(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(
        s, sim.all_reduce_sum(torch.from_numpy(vals)).numpy())
    np.testing.assert_array_equal(
        s, np.asarray(ref.all_reduce_sum(jnp.asarray(vals))))
    bm = torch.from_numpy(lens)
    assert float(gat.off_device_payload_bytes(bm)) == float(
        ref.off_device_payload_bytes(jnp.asarray(lens)))
    np.testing.assert_array_equal(
        gat.per_dev_sent_bytes(bm).numpy(),
        np.asarray(ref.per_dev_sent_bytes(jnp.asarray(lens))))


def _finalize_tuple(rng, ndev: int, complete: bool = True) -> tuple:
    """A ``finalize_wave``-shaped tuple: per-machine fields, a replicated
    f32 byte stat and ``complete``."""
    return (torch.from_numpy(rng.integers(0, 99, (ndev, 5, 3), np.int32)),
            torch.from_numpy(rng.random((ndev, 5)) < 0.5),
            torch.from_numpy(rng.integers(0, 9, ndev)),
            torch.tensor(complete),
            {"node_counts": torch.from_numpy(
                rng.integers(0, 9, (ndev, 3), np.int32)),
             "rows_per_round": torch.from_numpy(
                 rng.integers(0, 9, (3, ndev), np.int32)),
             "bytes_fetch": torch.tensor(16777217.0 * 3)})


@pytest.mark.parametrize("mode", ["sim", "gather"])
def test_whole_stack_finalize_round_trip(mode):
    """One process holds the stack: ``all_gather`` is ``x[None]``,
    ``broadcast_object`` the object, and the packed finalize tuple comes
    back field for field; the byte stats refuse a block of rows."""
    exch = Exchange(mode)
    fin = _finalize_tuple(np.random.default_rng(3), 4, complete=False)
    buf, layout = pack_result(fin)
    gathered = exch.all_gather(buf)
    assert gathered.shape == (1,) + tuple(buf.shape)
    assert exch.broadcast_object({"caps": 1}) == {"caps": 1}
    rows, alive, counts, complete, st = unpack_gathered(
        gathered.numpy(), layout)
    for got, want in ((rows, fin[0]), (alive, fin[1]), (counts, fin[2]),
                      *((st[k], v) for k, v in fin[4].items())):
        np.testing.assert_array_equal(got, want.numpy())
    assert complete is False and set(st) == set(fin[4])
    with pytest.raises(ValueError, match="gathered"):
        exch.off_device_bytes(torch.ones(1, 4, dtype=torch.int32), 4.0)


def test_unpack_gathered_reassembles_ranks():
    """Two ranks' packed halves: the per-machine fields concatenate by
    rank, ``complete`` is the AND, replicated fields must agree."""
    rng = np.random.default_rng(4)
    whole = _finalize_tuple(rng, 4)
    halves = []
    for r, done in ((0, True), (1, False)):
        part = (whole[0][2 * r:2 * r + 2], whole[1][2 * r:2 * r + 2],
                whole[2][2 * r:2 * r + 2], torch.tensor(done),
                {"node_counts": whole[4]["node_counts"][2 * r:2 * r + 2],
                 "rows_per_round": whole[4]["rows_per_round"][:, 2 * r:
                                                              2 * r + 2],
                 "bytes_fetch": whole[4]["bytes_fetch"]})
        halves.append(pack_result(part))
    layout = halves[0][1]
    host = torch.stack([b for b, _ in halves]).numpy()
    rows, alive, counts, complete, st = unpack_gathered(host, layout)
    for got, want in ((rows, whole[0]), (alive, whole[1]),
                      (counts, whole[2]),
                      *((st[k], v) for k, v in whole[4].items())):
        np.testing.assert_array_equal(got, want.numpy())
    assert complete is False
    names = [name for name, _, _ in layout]
    off = sum(int(np.prod(shape)) for name, shape, _ in
              layout[:names.index("bytes_fetch")])
    host[1, off] += 1
    with pytest.raises(RuntimeError, match="bytes_fetch"):
        unpack_gathered(host, layout)


@pytest.fixture(scope="module")
def small():
    return small_partitions()


@pytest.mark.parametrize("q", QS)
def test_gather_mode_matches_reference_gather(small, q):
    pg, tpg = small
    want = ref_enumerate(pg, RefPattern.from_edges(QUERIES[q]),
                         RefConfig(**CAPS, prewarm=False), mode="gather")
    got = rads_enumerate(tpg, Pattern.from_edges(QUERIES[q]),
                         EngineConfig(**CAPS), mode="gather", device="cpu")
    assert_same_result(got, want)


# --------------------------------------------------------------------------- #
# The rank-local device graph
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fmt", ["dense", "bucketed"])
def test_device_graph_block_matches_whole(small, fmt):
    _, tpg = small
    whole = device_graph(tpg, fmt, device="cpu")
    rng = np.random.default_rng(1)
    for dev0, nloc in ((0, 1), (3, 2), (7, 1), (0, 8)):
        part = device_graph(tpg, fmt, device="cpu", block=(dev0, nloc))
        assert (part.dev0, part.nloc, part.ndev) == (dev0, nloc, tpg.ndev)
        assert part.adj_bytes == whole.adj_bytes
        assert part.resident_bytes * tpg.ndev == whole.resident_bytes * nloc
        li = torch.from_numpy(rng.integers(0, tpg.stride, (nloc, 3, 7))
                              .astype(np.int32))
        for t0 in range(dev0, dev0 + nloc):
            i = t0 - dev0
            np.testing.assert_array_equal(
                part.rows_at(li[i:], t0).numpy(),
                whole.rows_at(li[i:], t0).numpy())
            np.testing.assert_array_equal(
                part.deg_at(li[i:], t0).numpy(),
                whole.deg_at(li[i:], t0).numpy())
        cache = AdjCache.build(tpg.ndev, 64, 2, tpg.n, tpg.max_degree,
                               nloc=nloc)
        assert cache.keys.shape[0] == nloc
        assert cache.cache_bytes == AdjCache.build(
            tpg.ndev, 64, 2, tpg.n, tpg.max_degree).cache_bytes
    # partition and export in one go, the reference's partition_device
    pg, part = partition_device(torch_erdos_graph(120, 5.0, seed=5), 8,
                                "bfs", fmt, device="cpu", block=(3, 2))
    np.testing.assert_array_equal(pg.adj, tpg.adj)
    np.testing.assert_array_equal(part.deg_at(
        torch.zeros((2, 1), dtype=torch.int32), 3).numpy()[:, 0],
        tpg.deg[3:5, 0])


# --------------------------------------------------------------------------- #
# merge_process_stats
# --------------------------------------------------------------------------- #
def test_merge_process_stats_matches_reference():
    base = dict(bytes_fetch=1234.0, bytes_wire_fetch_dev=[1.0, 2.0],
                n_waves=5, wire_format="varint", wave_s_total=0.5,
                wall_us=1000.0, dist_wall_us=900.0, process_index=0,
                process_count=2, comm_skew=1.25)
    other = dict(base, wave_s_total=0.75, wall_us=3000.0, dist_wall_us=100.0,
                 process_index=1)
    got, want = merge_process_stats([base, other]), ref_merge([base, other])
    assert got == want
    assert got["wall_us"] == 3000.0 and got["dist_wall_us"] == 900.0
    assert got["wall_skew"] == 1.5 and got["process_count"] == 2
    for key, bad in (("bytes_fetch", 1235.0), ("n_waves", 6),
                     ("bytes_wire_fetch_dev", [1.0, 3.0])):
        diverged = [base, dict(other, **{key: bad})]
        with pytest.raises(ValueError, match=key):
            merge_process_stats(diverged)
        with pytest.raises(ValueError, match=key):
            ref_merge(diverged)
    with pytest.raises(ValueError, match="at least one"):
        merge_process_stats([])


# --------------------------------------------------------------------------- #
# dist over real processes
# --------------------------------------------------------------------------- #
def _worker_args(wire: str, cache: bool) -> list[str]:
    args = ["--dataset", "dblp_bench", "--query", "q1", "--partition",
            "hash", "--wire", wire, *DIST_CAPS, "--device", "cpu"]
    return args if cache else [*args, "--no-cache"]


@pytest.fixture(scope="module")
def dist_runs():
    """The four two-process launches, run side by side, and what each is
    held to (computed while they run): raw with the cache against the
    reference's ``sim``, the others against the port's (which the parity
    tests hold to it)."""
    if not dist.is_gloo_available():
        pytest.fail("torch.distributed has gloo here: exit 3 is a failure")
    with concurrent.futures.ThreadPoolExecutor(len(DIST_CASES)) as ex:
        futs = {case: ex.submit(launch_local, 2, _worker_args(*case), 240.0)
                for case in DIST_CASES}
        wants = {}
        for wire, cache in DIST_CASES:
            cfg = worker_config(build_argparser().parse_args(
                _worker_args(wire, cache)))
            if (wire, cache) == ("raw", True):
                wants[wire, cache] = ref_enumerate(
                    ref_partition(ref_load_dataset("dblp_bench"), 2,
                                  method="hash"),
                    RefPattern.from_edges(QUERIES["q1"]),
                    RefConfig(**dict(dataclasses.asdict(cfg),
                                     prewarm=False)),
                    mode="sim", return_embeddings=False)
            else:
                wants[wire, cache] = rads_enumerate(
                    partition(load_dataset("dblp_bench"), 2, method="hash"),
                    Pattern.from_edges(QUERIES["q1"]), cfg, mode="sim",
                    return_embeddings=False, device="cpu")
        return {case: (f.result(), wants[case]) for case, f in futs.items()}


@pytest.mark.parametrize("wire,cache", DIST_CASES)
def test_dist_two_process_matches_sim(dist_runs, wire, cache):
    """The dist_worker launcher on two gloo processes equals ``sim`` on the
    same partition and configuration: count and every non-timing stat, on
    both ranks (see ``dist_runs`` for which ``sim``)."""
    workers, want = dist_runs[wire, cache]
    assert workers is not None, "launch_local reported exit 3 with gloo"
    assert [w["process_id"] for w in workers] == [0, 1]
    assert want.count > 0
    for rank, w in enumerate(workers):
        assert int(w["count"]) == want.count
        st = w["stats"]
        assert (st["process_index"], st["process_count"]) == (rank, 2)
        _assert_stats_equal(st, want.stats)
        assert sum(st["bytes_wire_fetch_dev"]) == st["bytes_wire_fetch"]
    merged = merge_process_stats([w["stats"] for w in workers])
    assert merged["process_count"] == 2 and merged["wall_skew"] >= 1.0


def test_dist_ranks_match_reference_embeddings():
    """Two spawned ranks each call ``rads_enumerate(mode="dist")`` on the
    small erdos graph split 2 ways (q2, bucketed storage, cache on; the
    varint wire under dist is the launches' above): both hold the
    reference's embeddings and stats."""
    if not dist.is_gloo_available():
        pytest.fail("torch.distributed has gloo here: exit 3 is a failure")
    pg = ref_partition(erdos_graph(120, 5.0, seed=5), 2, method="bfs")
    tpg = convert.partitioned_from_arrays({f: getattr(pg, f)
                                           for f in PG_FIELDS})
    kw = dict(CAPS, storage_format="bucketed")
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_spawned, tpg, [("q2", kw)], "cpu", 2, 180.0)
        want = ref_enumerate(pg, RefPattern.from_edges(QUERIES["q2"]),
                             RefConfig(**kw, prewarm=False))
        ranks = ranks.result()
    assert want.count > 0
    for rank, [(count, embs, stats, _)] in enumerate(ranks):
        assert count == want.count and embs == want.embeddings, rank
        assert (stats["process_index"], stats["process_count"]) == (rank, 2)
        _assert_stats_equal(stats, want.stats)
