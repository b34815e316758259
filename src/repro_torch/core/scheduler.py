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
does, so the byte accounting matches it.  The stages run eagerly, so
there is no compile stage, no executable store and no pre-warm.
"""
from __future__ import annotations

import dataclasses
import time
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
from repro_torch.obs.trace import (NULL_TRACER, TRACK_RETIRE, TRACK_SCHED,
                                   TRACK_WAVE0, now_us)

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
# StageRunner: the per-unit stages over one device graph
# --------------------------------------------------------------------------- #
class StageRunner:
    """Holds the device graph, the plan, the current capacities and the
    adjacency cache state, and dispatches the engine stages eagerly.

    Every dispatched fetch consumes ``self.cache`` and replaces it with
    the post-admission state, so the cache follows the fetches in dispatch
    order across waves and across capacity escalations (its geometry does
    not depend on the capacities).  ``cache="auto"`` builds it from
    ``cfg`` (``None`` when disabled)."""

    def __init__(self, g: DeviceGraph, pd: PlanData, cfg: EngineConfig,
                 exch: ExchangeBackend,
                 cache: AdjCache | None | str = "auto",
                 tracer=NULL_TRACER):
        self.g = g
        self.pd, self.exch = pd, exch
        self.cfg = cfg
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.cache = build_cache(cfg, g) if cache == "auto" else cache

    @property
    def n_units(self) -> int:
        return len(self.pd.unit_steps)

    def escalate(self) -> bool:
        """Double every engine capacity (up to the ceiling)."""
        c = self.cfg
        if c.frontier_cap >= _MAX_CAP:
            return False
        self.cfg = dataclasses.replace(
            c, frontier_cap=min(c.frontier_cap * 2, _MAX_CAP),
            fetch_cap=min(c.fetch_cap * 2, _MAX_CAP),
            verify_cap=min(c.verify_cap * 2, _MAX_CAP))
        return True

    def init(self, seeds: np.ndarray, mask: np.ndarray) -> WaveState:
        return init_wave(self.g, seeds, mask)

    def fetch(self, ui: int, state: WaveState, local_only: bool):
        if local_only:                       # SM-E: no exchanges at all
            return state, None
        state, bufs, self.cache = fetch_stage(self.g, self.pd, self.cfg,
                                              self.exch, ui, state, False,
                                              self.cache)
        return state, bufs

    def expand(self, ui: int, state: WaveState, bufs, local_only: bool):
        return expand_stage(self.g, self.pd, self.cfg, ui, state, bufs,
                            local_only)

    def verify(self, ui: int, state: WaveState, local_only: bool):
        return verify_stage(self.g, self.pd, self.cfg, self.exch, ui, state,
                            local_only)

    def finalize(self, state: WaveState):
        """Enqueue ``finalize_wave``, pack its tuple for one copy and
        all-gather every process's packed tuple (shapes static and equal
        on every process; one process's is the tuple itself)."""
        buf, layout = pack_result(finalize_wave(state))
        return self.exch.all_gather(buf), layout

    def retire(self, fin) -> tuple:
        """The wave's only synchronisation: one device-to-host copy."""
        buf, layout = fin
        return unpack_gathered(buf.cpu().numpy(), layout)


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
            w.fin = self.runner.finalize(w.state)
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
