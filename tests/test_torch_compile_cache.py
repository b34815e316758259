"""The port's stage-executable cache (``runtime/compile_cache.py`` and
``StageRunner``'s slot table) on the CPU.

The store's cases of ``tests/test_compile_cache.py``, with a payload of
kernel library bytes: a byte-identical round trip and a memo hit, key
mismatches (caps, wire, plan, signature) with expand shared across wire
formats, a corrupt file and a stale envelope dropped with a warning,
gating by ``compile_cache_dir``, the LRU budget and its touch on a disk
hit.  Then the slot table with a counting stand-in for the CUDA graph
capture (one build for two resolvers, old rungs serving after an
escalation, a pre-warmed rung hit without a build), whole runs in graph
mode through that stand-in against the eager path, and
``rads_enumerate``'s ``runner_cache``."""
import dataclasses
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.rads import QUERIES, EngineConfig
from repro_torch.core import Pattern, rads_enumerate
from repro_torch.core.cache import build_cache
from repro_torch.core.engine import build_plan_data, init_wave
from repro_torch.core.exchange import Exchange
from repro_torch.core.plan import best_plan
from repro_torch.core.scheduler import StageRunner
from repro_torch.graph import erdos_graph, partition
from repro_torch.graph.storage import device_graph
from repro_torch.kernels import build
from repro_torch.runtime.compile_cache import (StageExecCache, arg_signature,
                                               build_exec_cache,
                                               install_libraries,
                                               library_payload,
                                               stage_context)

torch.set_num_threads(1)
CAPS = dict(frontier_cap=1 << 12, fetch_cap=256, verify_cap=1024,
            region_group_budget=1 << 11)
# caps from which q6 escalates on the small graph
ESCALATE_CAPS = dict(frontier_cap=1 << 8, fetch_cap=16, verify_cap=64,
                     region_group_budget=1 << 11)
TIMING_KEYS = {"compiles", "compile_s", "compile_cache_hits", "wave_s_total",
               "sme_wall_us", "dist_wall_us", "wall_us", "sme_pipeline_s",
               "dist_pipeline_s", "exec_cache_enabled", "exec_cache"}
ARGS = (torch.arange(12, dtype=torch.float32).reshape(3, 4),
        torch.ones((4, 2), dtype=torch.int32))


@pytest.fixture(scope="module")
def pg():
    return partition(erdos_graph(120, 5.0, seed=5), 8, method="bfs")


@pytest.fixture
def payload(tmp_path):
    lib = tmp_path / f"libmembership-{'0123456789abcdef'}.so"
    lib.write_bytes(bytes(range(256)) * 4)
    return library_payload([lib])


def _store_one(cache, payload, cfg=None, args=ARGS):
    cfg = cfg or EngineConfig()
    sig = arg_signature(args)
    ctx = stage_context(("fetch", 0), cfg, "sim", "planA")
    d = cache.digest(("fetch", 0), sig, ctx)
    assert cache.store(d, sig, ctx, payload)
    return d, sig, ctx


def test_roundtrip_byte_identical(tmp_path, payload):
    cache = StageExecCache(str(tmp_path / "store"))
    d, sig, ctx = _store_one(cache, payload)
    StageExecCache.clear_memory_memo()       # force the disk path
    loaded = cache.load(d, sig, ctx)
    assert loaded == payload
    assert cache.stats["hits"] == 1 and cache.stats["errors"] == 0
    # the second load comes from the in-process memo, still a hit
    assert cache.load(d, sig, ctx) is loaded
    assert cache.stats["hits"] == 2


def test_key_mismatch_forces_recapture(tmp_path):
    cache = StageExecCache(str(tmp_path / "store"))
    cfg = EngineConfig()
    sig = arg_signature(ARGS)

    def dig(key, c, plan="planA", s=sig):
        return cache.digest(key, s, stage_context(key, c, "sim", plan))

    base = dig(("fetch", 0), cfg)
    assert dig(("fetch", 0),
               dataclasses.replace(cfg, fetch_cap=2 * cfg.fetch_cap)) != base
    assert dig(("fetch", 0),
               dataclasses.replace(cfg, wire_format="varint")) != base
    assert dig(("fetch", 0), cfg, plan="planB") != base
    sig2 = arg_signature((torch.zeros((6, 4)), ARGS[1]))
    assert dig(("fetch", 0), cfg, s=sig2) != base
    # expand's context ignores the wire format: both cells share it
    k = ("expand", 0, False)
    assert dig(k, cfg) == dig(k, dataclasses.replace(cfg,
                                                     wire_format="varint"))
    ctx = stage_context(("fetch", 0), cfg, "sim", "planA")
    assert cache.load(base, sig, ctx) is None
    assert dict(cache.stats) == dict(hits=0, misses=1, stores=0, errors=0,
                                     evictions=0)


def test_corrupt_file_warns_and_falls_back(tmp_path, payload):
    cache = StageExecCache(str(tmp_path / "store"))
    d, sig, ctx = _store_one(cache, payload)
    with open(cache._file(d), "wb") as f:
        f.write(b"not a pickle")
    StageExecCache.clear_memory_memo()
    with pytest.warns(RuntimeWarning, match="unusable entry"):
        assert cache.load(d, sig, ctx) is None
    assert cache.stats["errors"] == 1 and cache.stats["misses"] == 1
    assert cache.entries() == []             # the bad file was removed


def test_stale_envelope_rejected(tmp_path, payload):
    cache = StageExecCache(str(tmp_path / "store"))
    d, sig, ctx = _store_one(cache, payload)
    with open(cache._file(d), "rb") as f:
        env = pickle.load(f)
    env["material"] = "torch=0.0.0;some-other-build"
    with open(cache._file(d), "wb") as f:
        pickle.dump(env, f)
    StageExecCache.clear_memory_memo()
    with pytest.warns(RuntimeWarning, match="unusable entry"):
        assert cache.load(d, sig, ctx) is None
    assert cache.stats["errors"] == 1 and cache.entries() == []


def test_build_exec_cache_gating(tmp_path):
    assert build_exec_cache(EngineConfig()) is None
    c = build_exec_cache(EngineConfig(
        compile_cache_dir=str(tmp_path / "execs")))
    assert isinstance(c, StageExecCache) and c.enabled
    assert c.entries() == [] and c.budget_bytes == 0
    b = build_exec_cache(EngineConfig(
        compile_cache_dir=str(tmp_path / "execs2"),
        compile_cache_budget_bytes=1 << 20))
    assert b.budget_bytes == 1 << 20


def test_budget_gc_evicts_oldest(tmp_path, payload):
    cache = StageExecCache(str(tmp_path / "store"))
    entries = [_store_one(cache, payload, cfg=EngineConfig(fetch_cap=fc))
               for fc in (1 << 8, 1 << 9, 1 << 10)]
    files = [cache._file(d) for d, _, _ in entries]
    sizes = [os.path.getsize(f) for f in files]
    for i, f in enumerate(files):            # a fixed LRU order
        os.utime(f, (1000 + i, 1000 + i))
    cache.budget_bytes = sizes[1] + sizes[2]
    assert cache._gc() == 1 and cache.stats["evictions"] == 1
    assert not os.path.exists(files[0])
    assert os.path.exists(files[1]) and os.path.exists(files[2])
    StageExecCache.clear_memory_memo()
    assert cache.load(*entries[1]) == payload      # a survivor loads
    assert cache.load(*entries[0]) is None         # evicted: a plain miss


def test_store_triggers_gc_and_disk_hit_refreshes_lru(tmp_path, payload):
    cache = StageExecCache(str(tmp_path / "store"))
    d0, sig0, ctx0 = _store_one(cache, payload)
    f0 = cache._file(d0)
    os.utime(f0, (1000, 1000))
    StageExecCache.clear_memory_memo()
    assert cache.load(d0, sig0, ctx0) is not None
    assert os.path.getmtime(f0) > 1000       # the LRU touch
    os.utime(f0, (1000, 1000))
    cache.budget_bytes = os.path.getsize(f0) + 16
    d1, _, _ = _store_one(cache, payload, cfg=EngineConfig(fetch_cap=1 << 9))
    assert cache.entries() == [d1]           # d0 evicted by the store's gc
    assert cache.stats["evictions"] == 1


def test_payload_survives_the_build_directory(tmp_path, payload,
                                              monkeypatch):
    """A hit writes the stage's libraries back into an emptied build
    directory, atomically, and leaves a present one alone."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    assert install_libraries(payload) == 1
    (name, blob), = payload.items()
    assert (build.BUILD_DIR / name).read_bytes() == blob
    assert install_libraries(payload) == 0
    assert sorted(p.name for p in build.BUILD_DIR.iterdir()) == [name]


def test_meta_signature_equals_concrete(pg):
    """A wave on the ``meta`` device has a real wave's signature, as a
    placeholder of the reference's pre-warm has."""
    g = device_graph(pg, "dense", "cpu")
    state = init_wave(g, np.full((8, 16), g.n, np.int32),
                      np.zeros((8, 16), bool))
    meta = dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to("meta")
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})
    assert meta.rows.device.type == "meta"
    assert arg_signature((g, meta)) == arg_signature((g, state))
    assert arg_signature((g, meta)) != arg_signature(
        (device_graph(pg, "bucketed", "cpu"), state))


# --------------------------------------------------------------------------- #
# The slot table, with a counting stand-in for the capture
# --------------------------------------------------------------------------- #
class _Eager:
    """Stands in for a captured stage: runs it at build time and at each
    call, ``out`` the last outputs."""

    def __init__(self, fn, args):
        self.fn = fn
        self.out = fn(*args)

    def __call__(self, *args):
        self.out = self.fn(*args)
        return self.out


@pytest.fixture
def graph_mode(monkeypatch):
    """StageRunner in graph mode on the CPU; returns the list of builds."""
    built = []

    def capture(self, key, fn, args, cfg):
        built.append((key, self._caps_key(key, cfg)))
        return _Eager(fn, args), set()
    monkeypatch.setattr(StageRunner, "_can_capture",
                        lambda self: self.exch.whole_stack)
    monkeypatch.setattr(StageRunner, "_capture", capture)
    return built


def _runner(pg, q="q1", **kw):
    cfg = EngineConfig(**CAPS, **kw)
    g = device_graph(pg, cfg.storage_format, "cpu")
    pd = build_plan_data(best_plan(Pattern.from_edges(QUERIES[q]),
                                   cfg.plan_rho))
    return StageRunner(g, pd, cfg, Exchange("sim"), cache=build_cache(cfg, g))


def test_two_resolvers_build_one_slot(pg, graph_mode, monkeypatch):
    runner = _runner(pg)
    slow = StageRunner._capture

    def capture(self, key, fn, args, cfg):
        time.sleep(0.2)                      # the other thread arrives
        return slow(self, key, fn, args, cfg)
    monkeypatch.setattr(StageRunner, "_capture", capture)
    g, cfg = runner.g, runner.cfg
    state = runner.init(np.full((8, 16), g.n, np.int32),
                        np.zeros((8, 16), bool))
    args = (g, state, None)
    got = []

    def resolve():
        got.append(runner._resolve(("expand", 0, True),
                                   lambda: runner._make_expand(0, True, cfg),
                                   args, cfg))
    threads = [threading.Thread(target=resolve) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(graph_mode) == 1 and got[0] is got[1]
    assert runner.compiles == 1


def test_old_rung_serves_and_prewarmed_rung_hits(pg, graph_mode):
    runner = _runner(pg)
    g = runner.g
    n = runner.prewarm(16, local_only=False, escalation_rungs=1)
    # two rungs of fetch, expand, verify per unit and a finalize each
    assert n == len(graph_mode) == 2 * (3 * runner.n_units + 1)
    cfg0 = runner.cfg
    assert runner.escalate() and runner.cfg.frontier_cap == 2 * CAPS[
        "frontier_cap"]
    built = len(graph_mode)
    # a wave at the new rung runs on the pre-warmed slots alone
    state = runner.init(np.full((8, 16), g.n, np.int32),
                        np.zeros((8, 16), bool))
    for ui in range(runner.n_units):
        state, bufs = runner.fetch(ui, state, False)
        state = runner.expand(ui, state, bufs, False)
        state = runner.verify(ui, state, False)
    runner.retire(runner.finalize(state))
    assert len(graph_mode) == built
    # and the old rung's slots still serve
    assert runner.prewarm(16, local_only=False) == n // 2
    runner.cfg = cfg0
    assert runner.prewarm(16, local_only=False) == n // 2
    assert len(graph_mode) == built and runner.compiles == built


@pytest.mark.parametrize("q,kw", [
    ("q1", {}),
    ("q1", dict(storage_format="bucketed", wire_format="varint")),
    ("q6", ESCALATE_CAPS)])
def test_graph_mode_equals_eager(pg, graph_mode, monkeypatch, q, kw):
    """A whole run through the slot table (the adjacency cache copied
    into the runner's buffers after each fetch, store hits riding the
    finalize) gives the eager run's results and stats."""
    cfg = EngineConfig(**{**CAPS, **kw})
    pat = Pattern.from_edges(QUERIES[q])
    got = rads_enumerate(pg, pat, cfg, device="cpu")
    assert got.stats["compiles"] == len(graph_mode) > 0
    monkeypatch.undo()
    want = rads_enumerate(pg, pat, cfg, device="cpu")
    assert want.stats["compiles"] == 0
    assert got.count == want.count and got.embeddings == want.embeddings
    for k in set(want.stats) - TIMING_KEYS:
        assert got.stats[k] == want.stats[k], k


def test_warm_store_resolves_without_builds(pg, graph_mode, tmp_path):
    cfg = EngineConfig(**CAPS, compile_cache_dir=str(tmp_path / "store"))
    pat = Pattern.from_edges(QUERIES["q1"])
    cold = rads_enumerate(pg, pat, cfg, device="cpu")
    stages = cold.stats["compiles"]
    assert stages > 0 and cold.stats["exec_cache_enabled"]
    assert cold.stats["exec_cache"]["stores"] == stages
    StageExecCache.clear_memory_memo()
    warm = rads_enumerate(pg, pat, cfg, device="cpu")
    assert warm.stats["compiles"] == 0 and warm.stats["compile_s"] == 0.0
    assert warm.stats["compile_cache_hits"] == stages
    assert warm.stats["exec_cache"] == dict(hits=stages, misses=0, stores=0,
                                            errors=0, evictions=0)
    assert warm.count == cold.count and warm.embeddings == cold.embeddings


def test_runner_cache_reuses_the_runner(pg):
    """Two calls through ``runner_cache`` on the CPU: one runner, nothing
    captured, and the same stats (the adjacency cache off, so nothing
    carries over between the calls); with it on, the second call starts
    from the first's cache state, as the reference's does."""
    pat = Pattern.from_edges(QUERIES["q1"])
    for enable_cache in (False, True):
        cfg = EngineConfig(**CAPS, enable_cache=enable_cache)
        rc: dict = {}
        a = rads_enumerate(pg, pat, cfg, device="cpu", runner_cache=rc)
        runner = next(iter(rc.values()))[-1]
        b = rads_enumerate(pg, pat, cfg, device="cpu", runner_cache=rc)
        assert len(rc) == 1 and next(iter(rc.values()))[-1] is runner
        assert a.count == b.count and a.embeddings == b.embeddings
        for res in (a, b):
            assert res.stats["compiles"] == 0
            assert res.stats["exec_cache_enabled"] is False
        if not enable_cache:
            for k in set(a.stats) - TIMING_KEYS:
                assert a.stats[k] == b.stats[k], k
        else:
            assert b.stats["cache_hits"] > a.stats["cache_hits"]
            assert (a.stats["bytes_fetch"] + a.stats["bytes_saved_cache"]
                    == b.stats["bytes_fetch"] + b.stats["bytes_saved_cache"])
