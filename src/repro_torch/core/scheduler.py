"""Asynchronous region-group wave scheduler (the RADS pipeline driver).

The engine exposes each R-Meef unit as three stages over a
:class:`~repro_torch.core.engine.WaveState`:

    fetch_stage  -> expand_stage -> verify_stage        (one unit)

PyTorch launches CUDA work asynchronously, so a stage call returns as
soon as its kernels are enqueued.  The scheduler keeps up to
``EngineConfig.pipeline_depth`` waves in flight: it dispatches each
wave's stages and its ``finalize_wave`` back to back on the one CUDA
stream, and blocks only on the single device-to-host copy that retires
the oldest wave (:meth:`StageRunner.retire`).  With ``pipeline_depth=2``
the host forms and enqueues wave ``k+1`` while wave ``k`` still runs on
the card; ``pipeline_depth=1`` is the synchronous loop.

The robustness mechanisms are the reference's:

* **overflow split** (§6 memory control): an incomplete wave is halved and
  both halves re-queued (LIFO, so sub-waves finish before new groups);
* **capacity escalation**: a single-seed wave that still overflows doubles
  the engine capacities (enumeration never silently drops results);
* **steal-from-longest** (checkR/shareR): a device whose group queue
  drains early refills its slot from the tail of the longest queue;
* **per-seed cost calibration**: a running mean of trie-node counts over
  every completed wave;
* **adaptive pipeline depth** (``pipeline_depth="auto"``): the achieved
  concurrency ``Σ wave latency / wall`` steers the in-flight limit.  It
  is steered from wall time, as in the reference, so which waves are in
  flight when an escalation retires depends on the run: the schedule
  stats (``overflow_retries``, ``n_waves``, the per-device wire arrays,
  ``comm_skew``) of an auto-depth run may differ between runs and from
  the reference's, while counts and embeddings do not;
* **wave-level tracing** through :mod:`repro_torch.obs`, every record
  site guarded by ``tracer.enabled``.

Under the ``dist`` (and ``spmd``) exchange each rank holds its own
machine's slice of every wave.  :meth:`StageRunner.finalize` then makes
one all-gather of the packed result, and :meth:`StageRunner.retire`
reassembles the whole ``(ndev, ...)`` tuple on every rank, so the
group, retry, escalation and stealing logic below runs unchanged and
identically on every rank and each rank dispatches the same collectives
in the same order.  Under gloo a collective waits for the card's queued
work (its buffers cross through the host), so the pipeline's overlap of
host and card is lost there.

The adjacency cache is threaded through the fetches in dispatch order,
including waves later discarded for overflow, exactly as the reference
does, so the byte accounting matches it.

**Stage executables.**  On the card (``sim`` and ``gather``) every
``fetch``, ``expand``, ``verify`` and ``finalize`` call runs as a CUDA
graph resolved through :class:`StageRunner`'s two-level cache: an
in-process slot table keyed ``(stage, capacities, argument signature)``,
then the per-host store of :mod:`repro_torch.runtime.compile_cache`
(``EngineConfig.compile_cache_dir``), which keeps the kernel libraries
each stage's capture loaded.  A background pre-warm captures the stage
ladder of a phase while the host forms its groups, and a populated store
leaves nothing to build (``stats["compiles"] == 0``).  A wave's stages
read each other's graph outputs where they are; only ``init`` (host
seeds) stays eager, and the packed finalize result is copied out of its
graph at once, since younger waves replay that graph before the wave
retires.  A capture's warm-up may run on arguments that replays of other
graphs have overwritten, so the stages must not fault on any argument
values (:meth:`StageRunner._capture`).  On the CPU and under
``spmd``/``dist`` the stages run eagerly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.rads import EngineConfig
from repro_torch.core.cache import AdjCache, build_cache
from repro_torch.core.engine import (PlanData, WaveState, expand_stage,
                                     fetch_stage, finalize_wave, init_wave,
                                     verify_stage)
from repro_torch.core.exchange import ExchangeBackend
from repro_torch.graph.storage import DeviceGraph
from repro_torch.kernels import build
from repro_torch.kernels.intersect import ops as intersect_ops
from repro_torch.kernels.membership import ops as membership_ops
from repro_torch.kernels.varint import ops as varint_ops
from repro_torch.obs.trace import (NULL_TRACER, TRACK_PREWARM, TRACK_RETIRE,
                                   TRACK_SCHED, TRACK_WAVE0, now_us)
from repro_torch.runtime.compile_cache import (arg_signature,
                                               build_exec_cache,
                                               install_libraries,
                                               library_payload,
                                               stage_context)

_MAX_CAP = 1 << 22
_AUTO_START_DEPTH = 2       # pipeline_depth="auto" begins double-buffered
_MAX_AUTO_DEPTH = 8


def _pad_seeds(seeds_per_dev: list[np.ndarray], ndev: int, scap: int,
               sentinel: int) -> tuple[np.ndarray, np.ndarray]:
    out = np.full((ndev, scap), sentinel, dtype=np.int32)
    mask = np.zeros((ndev, scap), dtype=bool)
    for t, s in enumerate(seeds_per_dev):
        k = min(len(s), scap)
        out[t, :k] = s[:k]
        mask[t, :k] = True
    return out, mask


# --------------------------------------------------------------------------- #
# One device-to-host copy per retired wave
# --------------------------------------------------------------------------- #
_HOST_DTYPES = {torch.int32: np.int32, torch.int64: np.int64,
                torch.bool: np.bool_, torch.float32: np.float32}


def pack_result(fin) -> tuple[torch.Tensor, list]:
    """Flatten a ``finalize_wave`` tuple into one int32 tensor (f32 values
    bit-cast, bools and int64 counts narrowed) plus its layout, so a wave
    retires with a single device-to-host copy."""
    rows, alive, counts, complete, st = fin
    named = [("rows", rows), ("alive", alive), ("counts", counts),
             ("complete", complete), *sorted(st.items())]
    parts, layout = [], []
    for name, x in named:
        layout.append((name, tuple(x.shape), _HOST_DTYPES[x.dtype]))
        x = x.contiguous()
        parts.append((x.view(torch.int32) if x.dtype == torch.float32
                      else x.to(torch.int32)).reshape(-1))
    return torch.cat(parts), layout


def _unpack_fields(host: np.ndarray, layout: list) -> dict:
    out, off = {}, 0
    for name, shape, dtype in layout:
        size = int(np.prod(shape))
        chunk = host[off:off + size]
        off += size
        chunk = (chunk.view(np.float32) if dtype is np.float32
                 else chunk.astype(dtype))
        out[name] = chunk.reshape(shape)
    return out


# the fields of a finalize tuple that each rank holds for its own machines,
# by the axis of the machines; every other field but ``complete`` is
# replicated (the byte stats come from every machine's matrices)
_RANK_AXIS = {"rows": 0, "alive": 0, "counts": 0, "node_counts": 0,
              "rows_per_round": 1}


def unpack_gathered(host: np.ndarray, layout: list) -> tuple:
    """Inverse of :func:`pack_result` on the host copy of every process's
    packed result ``host (process_count, L)``: numpy arrays in the ``(rows,
    alive, counts, complete, stats)`` layout, the per-machine fields
    concatenated by process, ``complete`` the AND over processes, and the
    replicated fields process 0's, checked equal on every process."""
    parts = [_unpack_fields(h, layout) for h in host]
    out = {}
    for name, _, _ in layout:
        vals = [p[name] for p in parts]
        if name in _RANK_AXIS:
            out[name] = np.concatenate(vals, axis=_RANK_AXIS[name])
        elif name == "complete":
            out[name] = np.logical_and.reduce(vals)
        else:
            if any(v.tobytes() != vals[0].tobytes() for v in vals[1:]):
                raise RuntimeError(
                    f"replicated wave field {name!r} differs between ranks: "
                    f"{[v.tolist() for v in vals]}")
            out[name] = vals[0]
    rows, alive, counts, complete = (out.pop(k) for k in
                                     ("rows", "alive", "counts", "complete"))
    return rows, alive, counts, bool(complete), out


# --------------------------------------------------------------------------- #
# GroupQueue: one device's FIFO of region groups, optionally lazily formed
# --------------------------------------------------------------------------- #
class GroupQueue:
    """Per-device queue of region groups, pre-formed or pulled lazily
    from a group generator (:func:`repro_torch.core.region.
    iter_region_groups`) so the host forms wave ``k+1``'s groups while
    wave ``k`` runs on the card.  ``seeds_left`` is the steal-from-longest
    load metric."""

    def __init__(self, groups=(), lazy=None, n_lazy_seeds: int = 0):
        self._buf: deque[np.ndarray] = deque(groups)
        self._lazy = lazy
        self._lazy_left = int(n_lazy_seeds) if lazy is not None else 0
        self.n_formed = len(self._buf)

    @property
    def seeds_left(self) -> int:
        return sum(len(g) for g in self._buf) + self._lazy_left

    def __bool__(self) -> bool:
        return self.seeds_left > 0

    def _form(self) -> np.ndarray | None:
        if self._lazy is None:
            return None
        g = next(self._lazy, None)
        if g is None:
            self._lazy_left = 0
            return None
        self._lazy_left = max(0, self._lazy_left - len(g))
        self.n_formed += 1
        return g

    def pop_head(self) -> np.ndarray | None:
        if self._buf:
            return self._buf.popleft()
        return self._form()

    def pop_tail(self) -> np.ndarray | None:
        """Steal entry point: take buffered work from the tail, else form
        the victim's next group."""
        if self._buf:
            return self._buf.pop()
        return self._form()


# --------------------------------------------------------------------------- #
# Stage executables: CUDA graphs of one stage call
# --------------------------------------------------------------------------- #
# Every graph-mode enqueue (seed upload, copy-in, replay, copy-out, the
# retire copy) and every capture holds this lock, so no thread's CUDA
# calls of this path run while another thread holds a capture open; only
# waits for the card stay outside it.  A capture's warm-up allocates from
# its pool's free blocks, which are the intermediates of graphs already
# captured, so the capture's stream first waits for everything enqueued
# before it and the main stream then waits for the capture's work: no
# replay of the pool runs on the card while a warm-up does.  It also
# keeps the kernel wrappers' launch counts exact (see
# :func:`_launch_counts`).
_GRAPH_LOCK = threading.RLock()
_COUNTED = {"membership": membership_ops, "intersect": intersect_ops,
            "varint": varint_ops}


def _hold_pool(index: int) -> tuple:
    """A new graph memory pool on card ``index`` with one reference held
    (dropped by ``torch._C._cuda_releasePool``).  Not a
    ``torch.cuda.MemPool``: its destructor empties the pool at once, a
    synchronisation that aborts the process (it runs in a destructor) if
    a capture is open in any thread or the card has faulted.  A pool
    released here is only marked free; the allocator returns its memory at
    the next ``torch.cuda.empty_cache()`` or when an allocation runs
    short."""
    pool = torch.cuda.graph_pool_handle()
    torch._C._cuda_beginAllocateCurrentThreadToPool(index, pool)
    torch._C._cuda_endAllocateToPool(index, pool)
    return pool


@contextlib.contextmanager
def _allocating_to(index: int, pool):
    """Route this thread's allocations to ``pool``, as
    ``torch.cuda.use_mem_pool`` does for a ``MemPool``."""
    torch._C._cuda_beginAllocateCurrentThreadToPool(index, pool)
    try:
        yield
    finally:
        torch._C._cuda_endAllocateToPool(index, pool)
        torch._C._cuda_releasePool(index, pool)


def _end_capture(graph, index: int, pool) -> None:
    """``graph.capture_end()``.  When the capture was invalidated,
    ``capture_end`` raises before it stops routing the capture stream's
    allocations to ``pool``, which would leave a capture open in the
    allocator for the rest of the process: that routing is stopped here."""
    try:
        graph.capture_end()
    except BaseException:
        with contextlib.suppress(Exception):
            torch._C._cuda_endAllocateToPool(index, pool)
        raise


def _launch_counts() -> dict:
    """Every RADS kernel wrapper's launch counts, flattened."""
    out = {}
    for name, mod in _COUNTED.items():
        out[name, "launches", None] = mod.launches
        for k, n in getattr(mod, "shapes", {}).items():
            out[name, "shapes", k] = n
        for k, n in getattr(mod, "launches_by_variant", {}).items():
            out[name, "launches_by_variant", k] = n
    return out


def _credit(delta: dict, sign: int = 1) -> None:
    """Add ``delta`` (a difference of :func:`_launch_counts`) to the
    wrappers' counts: a capture records launches that do not run, and
    every replay runs them."""
    for (name, attr, k), n in delta.items():
        mod = _COUNTED[name]
        if k is None:
            mod.launches += sign * n
        else:
            getattr(mod, attr)[k] += sign * n


def _persistent(x) -> bool:
    """The runner's device graph and adjacency cache: a graph reads them
    where they are, and they are never copied in."""
    return isinstance(x, (DeviceGraph, AdjCache))


def _tensors(obj) -> list:
    """The tensors of a stage's arguments or outputs in a fixed order,
    the device graph's and the cache's left out."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if obj is None or _persistent(obj):
        return []
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj)
                for t in _tensors(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in _tensors(x)]
    return []


def _map_tensors(obj, fn):
    """``obj`` with every tensor of :func:`_tensors` replaced by
    ``fn(tensor)``."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if obj is None or _persistent(obj):
        return obj
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_tensors(x, fn) for x in obj)
    return obj


class _Graphed:
    """One stage call captured as a CUDA graph: ``args`` are the static
    arguments it was captured on, ``out`` the outputs its replays write,
    ``launches`` the kernel launches it holds.  A call copies each live
    argument tensor into its static one unless it is that tensor (the
    previous stage's output, as in every wave), replays, and returns
    ``out``."""

    def __init__(self, graph, args, out, launches: dict):
        self.graph, self.args, self.out = graph, args, out
        self.inputs = _tensors(args)
        self.launches = launches

    def __call__(self, *args):
        with _GRAPH_LOCK:
            for a, s in zip(args, self.args):
                if _persistent(a) and a is not s:
                    raise ValueError("a stage graph reads the device graph "
                                     "and cache it was captured with")
            for x, s in zip(_tensors(args), self.inputs):
                if x is not s:
                    s.copy_(x)
            self.graph.replay()
            _credit(self.launches)
        return self.out


def _copy_cache(dst: AdjCache, src: AdjCache) -> None:
    for name in ("keys", "rows", "benefit", "tick"):
        getattr(dst, name).copy_(getattr(src, name))


# --------------------------------------------------------------------------- #
# StageRunner: the per-unit stages over one device graph
# --------------------------------------------------------------------------- #
class StageRunner:
    """Holds the device graph, the plan, the current capacities and the
    adjacency cache state, and a two-level cache of stage executables:

    1. an in-process slot table keyed ``(stage key, capacities, argument
       signature)``, holding on the card one CUDA graph per stage call
       (:class:`_Graphed`);
    2. the optional persistent per-host store
       (:class:`~repro_torch.runtime.compile_cache.StageExecCache`,
       ``EngineConfig.compile_cache_dir``), consulted on every slot miss
       before a capture: its entry holds the kernel libraries the stage's
       capture loaded, which it writes back into the build directory.

    On the card (``sim`` and ``gather`` exchanges) a stage executable is
    made by a warm-up (one eager call, which builds and loads the stage's
    kernels), a capture of the same call into the runner's memory pool,
    and one replay.  ``init`` takes host arrays and stays eager; the
    first graph of a wave copies its outputs in, and every later stage
    reads its predecessor's outputs where they are.  ``compiles`` and
    ``compile_s`` count the executables made without the store (a warm
    run ends with ``compiles == 0``); a capture whose libraries came from
    the store counts as a store hit, drained by :meth:`take_hits` into
    the wave's ``finalize_wave`` (``exec_hits``).  A failed capture
    raises with the stage key and capacities.

    On the CPU, under ``spmd``/``dist`` (a gloo collective cannot be
    captured) and with ``eager=True`` (the switch the card tests and
    ``chip_smoke.py`` compare the two paths with), the stages run
    eagerly: nothing is captured, the store is not consulted and
    :meth:`prewarm` returns 0.

    ``prewarm``/``prewarm_async`` capture the ladder of a seed capacity
    from a placeholder wave on a background thread while the host forms
    groups.  Resolution is thread-safe: a second resolver of a pending
    slot waits for the first, and ``escalate`` bumps a generation
    counter that stops a pre-warm walk of old capacities.  Slots are
    keyed by the capacities they were captured at, so old-rung slots
    keep serving and a pre-warmed rung above is found by the escalation
    that reaches it.

    The adjacency cache is threaded through the fetches in dispatch
    order, across waves and escalations: eagerly, every fetch replaces
    ``self.cache``; on the card its tensors are the runner's own buffers,
    which every fetch graph reads and into which the fetch's new state is
    copied after each replay, so a warm-up or pre-warm never advances it.
    ``cache="auto"`` builds it from ``cfg`` (``None`` when disabled);
    ``exec_cache="auto"`` builds the store from ``cfg.compile_cache_dir``
    and an instance shares one store across runners."""

    def __init__(self, g: DeviceGraph, pd: PlanData, cfg: EngineConfig,
                 exch: ExchangeBackend,
                 cache: AdjCache | None | str = "auto",
                 exec_cache="auto", tracer=NULL_TRACER, eager: bool = False):
        self.g = g
        self.pd, self.exch = pd, exch
        self.cfg = cfg
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.cache = build_cache(cfg, g) if cache == "auto" else cache
        self.graphed = not eager and self._can_capture()
        self.exec_cache = (build_exec_cache(cfg) if exec_cache == "auto"
                           else exec_cache) if self.graphed else None
        self.compiles = 0        # stage executables made without the store
        self.compile_s = 0.0     # their warm-up + capture wall seconds
        self._slots: dict = {}   # (key, caps, sig) -> executable | Event
        self._lock = threading.Lock()
        self._gen = 0            # bumped by escalate(): stops old walks
        self._hits_pending = 0.0  # store hits awaiting wave attribution
        self._plan_repr = repr(pd)
        self._prewarm_threads: list[threading.Thread] = []
        self._tl = threading.local()   # per-thread last-resolve source
        self._pool = self._stream = None   # the graphs' pool id, stream
        self._pool_index = 0               # the pool's card
        self._static: set[int] = set()     # ids of every graph's tensors

    @property
    def n_units(self) -> int:
        return len(self.pd.unit_steps)

    def __del__(self):
        # the graphs go first, then the runner's own reference to their
        # pool; neither synchronises, so this is safe on any thread
        pool, self._pool = getattr(self, "_pool", None), None
        if pool is not None:
            self._slots.clear()
            with contextlib.suppress(Exception):
                torch._C._cuda_releasePool(self._pool_index, pool)

    def _can_capture(self) -> bool:
        """Stage graphs need the card and every machine in this process
        (a collective between processes is not captured)."""
        return self.g.device.type == "cuda" and self.exch.whole_stack

    @staticmethod
    def _escalated(cfg: EngineConfig) -> EngineConfig:
        """One rung up the capacity ladder: the replacement ``escalate()``
        applies, shared with the rung pre-warm."""
        return dataclasses.replace(
            cfg, frontier_cap=min(cfg.frontier_cap * 2, _MAX_CAP),
            fetch_cap=min(cfg.fetch_cap * 2, _MAX_CAP),
            verify_cap=min(cfg.verify_cap * 2, _MAX_CAP))

    def escalate(self) -> bool:
        """Double every engine capacity (up to the ceiling).  The slot
        table is kept: old-rung slots stay valid and pre-warmed slots of
        the new rung are found at once."""
        c = self.cfg
        if c.frontier_cap >= _MAX_CAP:
            return False
        with self._lock:
            self.cfg = self._escalated(c)
            self._gen += 1
        return True

    # -- persistent-store hit accounting ------------------------------------ #
    def take_hits(self) -> float:
        """Drain the pending store-hit count; the scheduler attributes it
        to the wave whose finalize is being dispatched."""
        with self._lock:
            h, self._hits_pending = self._hits_pending, 0.0
        return h

    def credit_hits(self, h: float) -> None:
        """Re-credit hits whose wave was discarded (overflow split or
        escalation) so that the run total stays exact."""
        with self._lock:
            self._hits_pending += float(h)

    # -- stage resolution ---------------------------------------------------- #
    @staticmethod
    def _caps_key(key, cfg: EngineConfig) -> tuple:
        """The capacity part of a slot key: ``init`` and ``finalize`` take
        their shapes from the signature alone."""
        if key in ("init", "finalize"):
            return ()
        return (cfg.frontier_cap, cfg.fetch_cap, cfg.verify_cap)

    def _resolve(self, key, make, args, cfg: EngineConfig):
        """The executable for ``(key, caps(cfg), signature(args))``: the
        slot, else the store's libraries and a capture, else a capture
        (counted).  ``cfg`` is the caller's snapshot, so a concurrent
        ``escalate`` cannot mismatch an executable and its key.  A second
        resolver of a pending slot waits for the first."""
        sig = arg_signature(args)
        skey = (key, self._caps_key(key, cfg), sig)
        while True:
            with self._lock:
                entry = self._slots.get(skey)
                if entry is None:
                    ev = threading.Event()
                    self._slots[skey] = ev
                    break
                if not isinstance(entry, threading.Event):
                    self._tl.last = "slot"
                    return entry
            entry.wait()
        fn = None
        tr = self.tracer
        t0_us = tr.now_us() if tr.enabled else 0.0
        source = "capture"
        try:
            ctx = digest = None
            if self.exec_cache is not None:
                ctx = stage_context(key, cfg, self.exch.mode,
                                    self._plan_repr)
                digest = self.exec_cache.digest(key, sig, ctx)
                payload = self.exec_cache.load(digest, sig, ctx)
                if payload is not None:
                    install_libraries(payload)
                    source = "store"
            t0 = time.perf_counter()
            fn, libs = self._capture(key, make(), args, cfg)
            dt = time.perf_counter() - t0
            with self._lock:
                if source == "store":
                    self._hits_pending += 1.0
                else:
                    self.compiles += 1
                    self.compile_s += dt
            if source == "capture" and self.exec_cache is not None:
                self.exec_cache.store(digest, sig, ctx,
                                      library_payload(libs))
            self._tl.last = source
            if tr.enabled:
                # on the prewarm lane when the background walk resolved it
                tid = (TRACK_PREWARM
                       if threading.current_thread().name
                       == "rads-stage-prewarm" else TRACK_SCHED)
                stage = key if isinstance(key, str) else ":".join(
                    str(k) for k in key)
                tr.complete(f"resolve:{stage}", tid, t0_us, source=source,
                            frontier_cap=cfg.frontier_cap)
            return fn
        finally:
            with self._lock:
                if fn is not None:
                    self._slots[skey] = fn
                elif self._slots.get(skey) is ev:
                    del self._slots[skey]
            ev.set()

    def _capture(self, key, fn, args, cfg: EngineConfig):
        """Make the executable of ``fn(*args)``: static copies of the
        argument tensors that are not already some graph's (the first
        stage of a wave), a warm-up call (which builds and loads the
        kernels), the capture, and one replay, so that the outputs hold a
        real call's values before any other stage reads them.  All of it
        in the runner's memory pool, on its own stream.  Returns the
        executable and the kernel libraries the stage launched from.

        The warm-up and the replay compute on the arguments as they stand.
        A pre-warm takes them from other graphs' outputs, which between a
        wave's replays hold whatever a replay of a graph sharing the pool
        last wrote there.  So every stage runs without a fault on any
        argument values (its data-dependent indices are clamped or
        masked), and no wave reads what such a call computes: a wave
        replays each graph before it reads the graph's outputs."""
        dev = self.g.device
        with _GRAPH_LOCK, torch.cuda.device(dev):
            if self._pool is None:
                self._pool_index = torch.cuda.current_device()
                self._pool = _hold_pool(self._pool_index)
                self._stream = torch.cuda.Stream(dev)
            pool, index = self._pool, self._pool_index
            side, main = self._stream, torch.cuda.default_stream(dev)
            side.wait_stream(main)
            before = None
            try:
                with torch.cuda.stream(side), build.record_loads() as libs:
                    with _allocating_to(index, pool):
                        static = _map_tensors(
                            args, lambda x: x if id(x) in self._static
                            else x.clone())
                        warm = fn(*static)
                        del warm
                    before = _launch_counts()
                    graph = torch.cuda.CUDAGraph()
                    graph.capture_begin(pool=pool,
                                        capture_error_mode="thread_local")
                    try:
                        out = fn(*static)
                    except BaseException:
                        with contextlib.suppress(Exception):
                            _end_capture(graph, index, pool)
                        raise
                    _end_capture(graph, index, pool)
                    launches = {k: n - before.get(k, 0)
                                for k, n in _launch_counts().items()
                                if n != before.get(k, 0)}
                    _credit(launches, -1)
                    before = None
                    exe = _Graphed(graph, static, out, launches)
                    exe(*static)
            except Exception as e:
                if before is not None:      # the failed capture's counts
                    _credit({k: n - before.get(k, 0) for k, n in
                             _launch_counts().items()}, -1)
                raise RuntimeError(
                    f"capturing stage {key!r} at capacities "
                    f"{self._caps_key(key, cfg)} failed: {e!r}") from e
            finally:
                main.wait_stream(side)
            self._static.update(id(t) for t in exe.inputs + _tensors(out))
        return exe, libs

    def _make_fetch(self, ui: int, cfg: EngineConfig):
        pd, exch = self.pd, self.exch
        return lambda gg, s, c: fetch_stage(gg, pd, cfg, exch, ui, s, False,
                                            c)

    def _make_expand(self, ui: int, local_only: bool, cfg: EngineConfig):
        pd = self.pd
        return lambda gg, s, b: expand_stage(gg, pd, cfg, ui, s, b,
                                             local_only)

    def _make_verify(self, ui: int, local_only: bool, cfg: EngineConfig):
        pd, exch = self.pd, self.exch
        return lambda gg, s: verify_stage(gg, pd, cfg, exch, ui, s,
                                          local_only)

    @staticmethod
    def _make_finalize():
        return lambda s, h: pack_result(finalize_wave(s, h))

    # -- stage dispatch ------------------------------------------------------ #
    def init(self, seeds: np.ndarray, mask: np.ndarray) -> WaveState:
        """Upload a padded seed block (eager in both modes: a graph would
        freeze the host copy)."""
        if not self.graphed:
            return init_wave(self.g, seeds, mask)
        with _GRAPH_LOCK:
            return init_wave(self.g, seeds, mask)

    def fetch(self, ui: int, state: WaveState, local_only: bool):
        if local_only:                       # SM-E: no exchanges at all
            return state, None
        cfg = self.cfg
        args = (self.g, state, self.cache)
        if not self.graphed:
            state, bufs, self.cache = self._make_fetch(ui, cfg)(*args)
            return state, bufs
        fn = self._resolve(("fetch", ui), lambda: self._make_fetch(ui, cfg),
                           args, cfg)
        with _GRAPH_LOCK:
            state, bufs, cache = fn(*args)
            if cache is not None:
                _copy_cache(self.cache, cache)
        return state, bufs

    def expand(self, ui: int, state: WaveState, bufs, local_only: bool):
        cfg = self.cfg
        args = (self.g, state, bufs)
        if not self.graphed:
            return self._make_expand(ui, local_only, cfg)(*args)
        return self._resolve(("expand", ui, local_only),
                             lambda: self._make_expand(ui, local_only, cfg),
                             args, cfg)(*args)

    def verify(self, ui: int, state: WaveState, local_only: bool):
        cfg = self.cfg
        args = (self.g, state)
        if not self.graphed:
            return self._make_verify(ui, local_only, cfg)(*args)
        return self._resolve(("verify", ui, local_only),
                             lambda: self._make_verify(ui, local_only, cfg),
                             args, cfg)(*args)

    def finalize(self, state: WaveState, exec_hits: float = 0.0):
        """Enqueue ``finalize_wave`` with the wave's store hits, pack its
        tuple for one copy and all-gather every process's packed tuple
        (shapes static and equal on every process; one process's is the
        tuple itself).  A graph's packed output is copied out at once:
        the next wave's replay writes it again before this wave
        retires."""
        if not self.graphed:
            buf, layout = pack_result(finalize_wave(state, exec_hits))
            return self.exch.all_gather(buf), layout
        with _GRAPH_LOCK:
            hits = torch.full((), float(exec_hits), dtype=torch.float32,
                              device=self.g.device)
        args = (state, hits)
        fn = self._resolve("finalize", self._make_finalize, args, self.cfg)
        with _GRAPH_LOCK:
            buf, layout = fn(*args)
            buf = buf.clone()
        return self.exch.all_gather(buf), layout

    def retire(self, fin) -> tuple:
        """The wave's only synchronisation: one device-to-host copy (in
        graph mode enqueued under the graph lock, into pinned memory, and
        waited for outside it)."""
        buf, layout = fin
        if not self.graphed or buf.device.type != "cuda":
            return unpack_gathered(buf.cpu().numpy(), layout)
        with _GRAPH_LOCK:
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(buf.device))
        done.synchronize()
        return unpack_gathered(host.numpy(), layout)

    # -- pre-warm ------------------------------------------------------------ #
    def _prewarm_ladder(self, scap: int, local_only: bool,
                        cfg: EngineConfig, gen: int) -> int:
        """Resolve the stage ladder at ``cfg``'s capacities from a
        placeholder wave (all-sentinel seeds, nothing alive): each stage's
        arguments are its predecessor's graph outputs, as in a real wave.
        Returns the stages resolved, 0 if a concurrent escalation stopped
        the walk."""
        g = self.g
        with _GRAPH_LOCK:
            state = init_wave(g, np.full((g.ndev, scap), g.n,
                                         dtype=np.int32),
                              np.zeros((g.ndev, scap), dtype=bool))
        n = 0
        for ui in range(self.n_units):
            if self._gen != gen:
                return 0
            bufs = None
            if not local_only:
                state, bufs, _ = self._resolve(
                    ("fetch", ui), lambda: self._make_fetch(ui, cfg),
                    (g, state, self.cache), cfg).out
                n += 1
            state = self._resolve(
                ("expand", ui, local_only),
                lambda: self._make_expand(ui, local_only, cfg),
                (g, state, bufs), cfg).out
            state = self._resolve(
                ("verify", ui, local_only),
                lambda: self._make_verify(ui, local_only, cfg),
                (g, state), cfg).out
            n += 2
        hits = torch.zeros((), dtype=torch.float32, device=g.device)
        self._resolve("finalize", self._make_finalize, (state, hits), cfg)
        return n + 1

    def prewarm(self, scap: int, local_only: bool,
                escalation_rungs: int = 0) -> int:
        """Resolve every stage executable of seed capacity ``scap`` before
        the waves need them, and with ``escalation_rungs > 0`` that many
        capacity rungs above (doubled as ``escalate()`` doubles them).
        Returns the number of stages resolved: 0 when a concurrent
        escalation stopped it, and 0 where the stages run eagerly."""
        if not self.graphed:
            return 0
        gen = self._gen
        cfg = self.cfg
        with self.tracer.span("prewarm", TRACK_PREWARM, scap=int(scap),
                              local_only=bool(local_only),
                              rungs=int(escalation_rungs)):
            n = self._prewarm_ladder(scap, local_only, cfg, gen)
            for _ in range(max(0, int(escalation_rungs))):
                if n == 0 or cfg.frontier_cap >= _MAX_CAP:
                    break
                cfg = self._escalated(cfg)
                r = self._prewarm_ladder(scap, local_only, cfg, gen)
                n = n + r if r else n
        return n

    def prewarm_async(self, scap: int, local_only: bool,
                      escalation_rungs: int = 0) -> threading.Thread:
        """Run :meth:`prewarm` on a daemon thread named
        ``rads-stage-prewarm`` (the driver starts one before each
        scheduler phase).  Join with :meth:`join_prewarm` before reading
        ``compiles``/``compile_s``.  A failure warns: the main path then
        resolves what it needs itself, and raises if that fails."""
        def work():
            try:
                self.prewarm(scap, local_only, escalation_rungs)
            except Exception as e:
                warnings.warn(f"stage pre-warm (scap={scap}, local_only="
                              f"{local_only}) failed: {e!r}", RuntimeWarning)
        th = threading.Thread(target=work, name="rads-stage-prewarm",
                              daemon=True)
        th.start()
        self._prewarm_threads.append(th)
        return th

    def join_prewarm(self) -> None:
        for th in self._prewarm_threads:
            th.join()
        self._prewarm_threads.clear()


# --------------------------------------------------------------------------- #
# Pipeline scheduler
# --------------------------------------------------------------------------- #
@dataclass
class _Wave:
    """One in-flight region-group wave: host-side batches (for the split
    loop), the device-side state, a stage cursor, and — once every stage
    is dispatched — the packed finalize result (``fin``)."""
    batches: list[np.ndarray]
    mask: np.ndarray
    state: WaveState
    stages: list[tuple[str, int]]
    pos: int = 0
    bufs: object = None
    fin: object = None
    t_start: float = field(default_factory=time.perf_counter)
    seq: int = 0                # wave sequence number == trace flow id
    tid: int = 0                # trace lane (TRACK_WAVE0 + lane), 0 = untraced
    t0_us: float = 0.0          # span-clock admit time (traced runs only)


class PipelineScheduler:
    """Drives region-group waves through the staged engine with up to
    ``cfg.pipeline_depth`` waves in flight (see module docstring).

    ``stats`` may be a plain dict or a
    :class:`repro_torch.obs.metrics.MetricsRegistry`."""

    def __init__(self, runner: StageRunner, stats: dict, consume,
                 tracer=None):
        self.runner = runner
        self.stats = stats
        self.consume = consume      # (rows, alive, counts, st, phase) -> None
        self.tracer = (tracer if tracer is not None
                       else getattr(runner, "tracer", NULL_TRACER))
        self._wave_seq = 0          # monotone wave counter (trace flow ids)
        self._free_lanes: list[int] = []
        self._n_lanes = 0

    # -- wave formation ----------------------------------------------------- #
    def _next_wave(self, queues: list[GroupQueue], retry: list,
                   scap: int, local_only: bool):
        """Pop the next wave: retries first (LIFO), else one group per
        device queue with steal-from-longest refill; oversized batches are
        chunked to ``scap``."""
        cfg = self.runner.cfg
        empty = np.array([], dtype=np.int64)
        while True:
            if retry:
                wave = retry.pop()
            elif any(queues):
                wave = [q.pop_head() if q else None for q in queues]
                wave = [empty if b is None else b for b in wave]
                # both knobs gate the checkR/shareR analogue
                if (cfg.enable_work_stealing and cfg.steal_from_longest
                        and not local_only):
                    for t, b in enumerate(wave):
                        if len(b) > 0:
                            continue
                        src = max(range(len(queues)),
                                  key=lambda u: queues[u].seeds_left)
                        if queues[src]:       # this device drained early:
                            stolen = queues[src].pop_tail()
                            if stolen is not None:
                                wave[t] = stolen
                                self.stats["steal_events"] += 1
                                if self.tracer.enabled:
                                    self.tracer.instant(
                                        "steal", TRACK_SCHED, dev=t,
                                        victim=src, seeds=len(stolen))
            else:
                return None
            if max((len(b) for b in wave), default=0) == 0:
                continue
            if max(len(b) for b in wave) > scap:
                retry.append([b[scap:] for b in wave])
                wave = [b[:scap] for b in wave]
            return wave

    def _admit(self, wave: list[np.ndarray], scap: int) -> _Wave:
        g = self.runner.g
        seeds, mask = _pad_seeds(wave, g.ndev, scap, g.n)
        stages = [(kind, ui) for ui in range(self.runner.n_units)
                  for kind in ("fetch", "expand", "verify")]
        tr = self.tracer
        if not tr.enabled:
            return _Wave(batches=wave, mask=mask,
                         state=self.runner.init(seeds, mask), stages=stages)
        # traced admission: allocate the smallest free wave lane, open the
        # whole-life flow (dispatch -> retire arrow) inside the init span
        if self._free_lanes:
            lane = min(self._free_lanes)
            self._free_lanes.remove(lane)
        else:
            lane = self._n_lanes
            self._n_lanes += 1
        seq = self._wave_seq
        self._wave_seq += 1
        tid = TRACK_WAVE0 + lane
        tr.name_track(tid, f"wave lane {lane}")
        t0 = tr.now_us()
        state = self.runner.init(seeds, mask)
        tr.flow_start(seq, tid)
        tr.complete("init", tid, t0, wave=seq,
                    seeds=int(sum(len(b) for b in wave)), scap=int(scap))
        return _Wave(batches=wave, mask=mask, state=state, stages=stages,
                     seq=seq, tid=tid, t0_us=t0)

    def _dispatch_one(self, kind: str, ui: int, w: _Wave, local_only: bool):
        if kind == "fetch":
            w.state, w.bufs = self.runner.fetch(ui, w.state, local_only)
        elif kind == "expand":
            w.state = self.runner.expand(ui, w.state, w.bufs, local_only)
            w.bufs = None
        else:
            w.state = self.runner.verify(ui, w.state, local_only)

    def _dispatch(self, w: _Wave, local_only: bool):
        kind, ui = w.stages[w.pos]
        tr = self.tracer
        if tr.enabled:
            # per-stage span on the wave's lane: host enqueue time only
            # (the launches return before the card runs them)
            name = f"{kind}:u{ui}"
            t0 = tr.now_us()
            with tr.device_span(name):
                self._dispatch_one(kind, ui, w, local_only)
            tr.complete(name, w.tid, t0, wave=w.seq, unit=ui,
                        frontier_cap=self.runner.cfg.frontier_cap)
        else:
            self._dispatch_one(kind, ui, w, local_only)
        w.pos += 1

    def _drain(self, w: _Wave, local_only: bool):
        """Dispatch ALL of a wave's remaining stages, then its finalize —
        contiguously, so the wave's kernels sit back to back on the
        in-order stream and the retire copy never waits behind a younger
        wave's stages."""
        while w.pos < len(w.stages):
            self._dispatch(w, local_only)
        if w.fin is None:
            tr = self.tracer
            t0 = tr.now_us() if tr.enabled else 0.0
            # every stage this wave needed was resolved by its dispatches
            # above, so the drained store hits are this wave's (hits of a
            # pre-warm land on the next wave to finalize: same totals)
            w.fin = self.runner.finalize(w.state, self.runner.take_hits())
            w.state = None
            if tr.enabled:
                tr.complete("finalize", w.tid, t0, wave=w.seq)

    # -- retire + robustness loop ------------------------------------------- #
    def _retire(self, w: _Wave, retry: list, phase: str
                ) -> tuple[float, int]:
        """Block on the wave's result copy; consume on success,
        split/escalate on overflow.  Returns (node_cost_sum, n)."""
        tr = self.tracer
        t0 = tr.now_us() if tr.enabled else 0.0
        rows, alive, counts, complete, st = self.runner.retire(w.fin)
        w.fin = None
        if tr.enabled and w.tid:
            tr.flow_end(w.seq, TRACK_RETIRE)
            tr.complete("retire", TRACK_RETIRE, t0, wave=w.seq,
                        complete=complete)
            tr.complete("wave", w.tid, w.t0_us, wave=w.seq,
                        complete=complete)
            self._free_lanes.append(w.tid - TRACK_WAVE0)
        if not complete:
            # a discarded wave's stats never reach consume: hand its store
            # hits back so that the run total stays exact
            self.runner.credit_hits(float(st["compile_cache_hits"]))
            if max(len(b) for b in w.batches) <= 1:
                if not self.runner.escalate():
                    raise RuntimeError("capacity ceiling reached")
                self.stats["cap_escalations"] += 1
                retry.append(w.batches)
                if tr.enabled:
                    tr.instant("cap_escalation", TRACK_SCHED, wave=w.seq,
                               frontier_cap=self.runner.cfg.frontier_cap)
            else:
                self.stats["overflow_retries"] += 1
                retry.append([b[len(b) // 2:] for b in w.batches])
                retry.append([b[:len(b) // 2] for b in w.batches])
                if tr.enabled:
                    tr.instant("overflow_split", TRACK_SCHED, wave=w.seq)
            return 0.0, 0
        # per-real-seed trie-node counts (padding slots masked)
        nc = st["node_counts"][w.mask]
        st["seed_node_counts"] = nc
        self.consume(rows, alive, counts, st, phase)
        self.stats["wave_s_total"] += time.perf_counter() - w.t_start
        return float(nc.sum()), int(nc.size)

    # -- main loop ----------------------------------------------------------- #
    def run(self, queues, scap: int, local_only: bool, phase: str,
            depth=None, auto_start: int | None = None) -> float | None:
        """Process per-device group queues (GroupQueue instances or plain
        lists of seed arrays) until empty.  Returns the mean trie-node cost
        per completed seed (running mean over all waves).

        ``depth`` overrides ``cfg.pipeline_depth``; ``"auto"`` adapts it
        from the achieved concurrency, starting at ``auto_start``."""
        if depth is None:
            depth = self.runner.cfg.pipeline_depth
        auto = depth == "auto"
        if auto:
            depth = int(auto_start) if auto_start else _AUTO_START_DEPTH
            depth = max(1, min(depth, _MAX_AUTO_DEPTH))
        else:
            depth = max(1, int(depth))
        queues = [q if isinstance(q, GroupQueue) else GroupQueue(q)
                  for q in queues]
        retry: list[list[np.ndarray]] = []
        inflight: deque[_Wave] = deque()
        cost_sum, cost_n = 0.0, 0
        waves_done, wave_s_phase = 0, 0.0
        tr = self.tracer
        if tr.enabled:
            tr.name_track(TRACK_SCHED, "scheduler")
            tr.name_track(TRACK_RETIRE, "retire")
            tr.name_track(TRACK_PREWARM, "prewarm")
        t0 = time.perf_counter()
        tp0 = now_us()     # span clock — same domain as every trace event
        while True:
            # 1. fill the pipeline to ``depth``: each admitted wave enqueues
            #    all its stages plus its finalize, so host-side group
            #    formation for the next wave overlaps the card's work
            while len(inflight) < depth:
                if tr.enabled:
                    t0g = tr.now_us()
                    wave = self._next_wave(queues, retry, scap, local_only)
                    tr.complete("group_form", TRACK_SCHED, t0g,
                                got=wave is not None)
                else:
                    wave = self._next_wave(queues, retry, scap, local_only)
                if wave is None:
                    break
                w = self._admit(wave, scap)
                inflight.append(w)
                self._drain(w, local_only)
                self.stats["n_waves"] += 1
                self.stats["max_inflight_waves"] = max(
                    self.stats["max_inflight_waves"], len(inflight))
            if not inflight:
                break
            # 2. retire the oldest wave.  If retiring escalates capacities,
            #    every younger in-flight wave already ran at the old caps;
            #    overflow is re-checked at its own retire, so it stays exact.
            oldest = inflight.popleft()
            s, n = self._retire(oldest, retry, phase)
            cost_sum += s
            cost_n += n
            waves_done += 1
            wave_s_phase += time.perf_counter() - oldest.t_start
            if auto and waves_done >= 2:
                wall = max(time.perf_counter() - t0, 1e-9)
                achieved = wave_s_phase / wall       # mean in-flight waves
                if achieved >= depth - 0.5 and depth < _MAX_AUTO_DEPTH:
                    depth += 1
                elif achieved < depth - 1.25 and depth > 1:
                    depth -= 1
                self.stats["auto_depth"] = depth
        if auto:
            self.stats["auto_depth"] = depth
        self.stats[f"{phase}_pipeline_s"] = (
            self.stats.get(f"{phase}_pipeline_s", 0.0)
            + time.perf_counter() - t0)
        wall = now_us() - tp0
        self.stats[f"{phase}_wall_us"] = (
            self.stats.get(f"{phase}_wall_us", 0.0) + wall)
        if tr.enabled:
            tr.complete(f"phase:{phase}", TRACK_SCHED, tp0, dur_us=wall,
                        depth=depth, local_only=bool(local_only))
        return cost_sum / cost_n if cost_n else None
