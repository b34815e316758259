"""Host-side span recorder -> Chrome trace-event JSON (Perfetto).

See the package docstring (:mod:`repro_torch.obs`) for the design note.  The
short version of the contract this module keeps:

* **one clock domain**: every timestamp comes from :func:`now_us` — a
  process-wide monotonic ``time.perf_counter_ns`` anchored at import —
  so spans recorded on the scheduler thread, the prewarm thread, and the
  phase wall-clock the driver reports (``stats["*_wall_us"]``) are all
  directly comparable, and merged multi-process traces only differ by a
  per-process anchor offset (lanes stay internally consistent);
* **preallocated ring**: :class:`TraceRecorder` writes fixed-shape
  record tuples into a preallocated slot list — recording is an O(1)
  index-modulo store, the buffer never grows, and overflow silently
  drops the *oldest* records (the count is reported in the export);
* **host scalars only**: the recorder never touches device values — all
  arguments are pre-fetched host scalars, so instrumentation can never
  introduce a host-device synchronisation;
* **zero instruments when off**: the scheduler holds :data:`NULL_TRACER`
  unless a recorder was passed in, and its hot-loop record sites are
  guarded by ``tracer.enabled`` — the off path executes no span code at
  all, which is what makes tracing-on vs tracing-off byte-identical in
  counts and ``bytes_wire_*``.

Track (``tid``) layout:

====================  =====================================================
``TRACK_SCHED`` (1)   scheduler events: phase spans, group formation,
                      steal / overflow-split / cap-escalation instants
``TRACK_RETIRE`` (2)  retire: the single blocking device-to-host copy
                      per wave, carrying the flow-arrow *end* per wave
``TRACK_PREWARM`` (3) kept for the reference's track numbering; the
                      port runs its stages eagerly and has no prewarm
``TRACK_WAVE0+k``     one lane per *in-flight* wave slot: init /
                      fetch:uN / expand:uN / verify:uN / finalize
                      dispatch spans plus a whole-life ``wave`` span,
                      carrying the flow-arrow *start*
====================  =====================================================

Flow arrows: admission emits ``ph="s"`` (id = wave sequence number)
inside the wave lane's ``init`` span; retirement emits ``ph="f"`` with
``bp="e"`` inside the retire span — Perfetto draws the dispatch→retire
arrow per wave.  ``device_span`` optionally bridges to
``torch.cuda.nvtx.range`` so device profiles line up with these host
spans when a CUDA profiler session is active.
"""
from __future__ import annotations

import json
import time

__all__ = ["NULL_TRACER", "NullTracer", "TraceRecorder", "now_us",
           "merge_traces", "TRACK_SCHED", "TRACK_RETIRE", "TRACK_PREWARM",
           "TRACK_WAVE0"]

TRACK_SCHED = 1      # scheduler events (phases, group formation, instants)
TRACK_RETIRE = 2     # retire/finalize: the blocking device_get per wave
TRACK_PREWARM = 3    # background prewarm + stage resolution
TRACK_WAVE0 = 16     # first wave lane; lane k lives at TRACK_WAVE0 + k

_T0_NS = time.perf_counter_ns()


def now_us() -> float:
    """Monotonic microseconds since process trace epoch (import time).

    The single clock domain for every span *and* for the scheduler's
    per-phase ``wall_us`` stats, so wall-clock honesty and the timeline
    agree by construction."""
    return (time.perf_counter_ns() - _T0_NS) / 1e3


class _NullCM:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CM = _NullCM()


class NullTracer:
    """The off path: every method is a no-op, ``enabled`` is False so hot
    loops can skip even the call.  A singleton (:data:`NULL_TRACER`) is
    the default everywhere — holding it adds zero instruments."""

    __slots__ = ()
    enabled = False

    def now_us(self) -> float:
        return 0.0

    def complete(self, name, tid, ts_us, dur_us=None, **args):
        pass

    def instant(self, name, tid, **args):
        pass

    def flow_start(self, fid, tid, name="wave"):
        pass

    def flow_end(self, fid, tid, name="wave"):
        pass

    def name_track(self, tid, name):
        pass

    def span(self, name, tid, **args):
        return _NULL_CM

    def device_span(self, name):
        return _NULL_CM


NULL_TRACER = NullTracer()


class _Span:
    """Context manager recording one complete ('X') event on exit."""

    __slots__ = ("_rec", "_name", "_tid", "_args", "_t0")

    def __init__(self, rec, name, tid, args):
        self._rec, self._name, self._tid, self._args = rec, name, tid, args

    def __enter__(self):
        self._t0 = now_us()
        return self

    def __exit__(self, *exc):
        self._rec._push(("X", self._name, self._tid, self._t0,
                         now_us() - self._t0, None, self._args))
        return False


class TraceRecorder:
    """Monotonic-clock ring-buffer span recorder (see module docstring).

    ``capacity`` bounds the ring (records, not bytes); ``pid`` becomes
    the Chrome-trace process lane (the dist worker passes its process
    index so merged traces keep one lane group per process);
    ``nvtx_bridge=True`` makes :meth:`device_span` emit a matching
    ``torch.cuda.nvtx.range`` around each stage dispatch."""

    enabled = True

    def __init__(self, capacity: int = 1 << 16, pid: int = 0,
                 nvtx_bridge: bool = False):
        if capacity < 8:
            raise ValueError(f"trace ring capacity too small: {capacity}")
        self._ring: list = [None] * int(capacity)
        self._cap = int(capacity)
        self._n = 0                      # total records ever pushed
        self.pid = int(pid)
        self.nvtx_bridge = bool(nvtx_bridge)
        self._track_names: dict[int, str] = {}

    # -- recording (hot path: one tuple + one slot store) -------------------- #
    def now_us(self) -> float:
        return now_us()

    def _push(self, rec: tuple) -> None:
        self._ring[self._n % self._cap] = rec
        self._n += 1

    def complete(self, name: str, tid: int, ts_us: float,
                 dur_us: float | None = None, **args) -> None:
        """Record a complete ('X') span given its pre-fetched host-scalar
        start (and optionally duration); no device value ever enters."""
        if dur_us is None:
            dur_us = now_us() - ts_us
        self._push(("X", name, tid, ts_us, dur_us, None, args or None))

    def instant(self, name: str, tid: int, **args) -> None:
        self._push(("i", name, tid, now_us(), 0.0, None, args or None))

    def flow_start(self, fid: int, tid: int, name: str = "wave") -> None:
        self._push(("s", name, tid, now_us(), 0.0, int(fid), None))

    def flow_end(self, fid: int, tid: int, name: str = "wave") -> None:
        self._push(("f", name, tid, now_us(), 0.0, int(fid), None))

    def name_track(self, tid: int, name: str) -> None:
        self._track_names.setdefault(int(tid), str(name))

    def span(self, name: str, tid: int, **args) -> _Span:
        """``with tracer.span("prewarm", TRACK_PREWARM, scap=64): ...``"""
        return _Span(self, name, tid, args or None)

    def device_span(self, name: str):
        """Optional NVTX bridge: a ``torch.cuda.nvtx.range`` matching the
        host span, so device profiles line up with these lanes.  A
        no-op context manager unless ``nvtx_bridge`` was requested."""
        if not self.nvtx_bridge:
            return _NULL_CM
        import torch

        return torch.cuda.nvtx.range(name)

    # -- export --------------------------------------------------------------- #
    @property
    def n_recorded(self) -> int:
        return self._n

    @property
    def n_dropped(self) -> int:
        return max(0, self._n - self._cap)

    def records(self) -> list[tuple]:
        """Ring contents in record order (oldest surviving first)."""
        if self._n <= self._cap:
            return [r for r in self._ring[:self._n]]
        head = self._n % self._cap
        return self._ring[head:] + self._ring[:head]

    def events(self) -> list[dict]:
        """Chrome trace-event dicts: track metadata first, then the ring
        in record order.  Every event carries ``ph/ts/pid/tid``."""
        pid = self.pid
        out: list[dict] = [dict(name="process_name", ph="M", ts=0, pid=pid,
                                tid=0, args=dict(name=f"rads p{pid}"))]
        for tid, name in sorted(self._track_names.items()):
            out.append(dict(name="thread_name", ph="M", ts=0, pid=pid,
                            tid=tid, args=dict(name=name)))
        for ph, name, tid, ts, dur, fid, args in self.records():
            ev = dict(name=name, ph=ph, ts=ts, pid=pid, tid=tid, cat="rads")
            if ph == "X":
                ev["dur"] = dur
            elif ph == "i":
                ev["s"] = "t"
            elif ph in ("s", "f"):
                ev["cat"] = "wave-flow"
                ev["id"] = fid
                if ph == "f":
                    ev["bp"] = "e"   # bind to the enclosing retire span
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def to_chrome(self) -> dict:
        return {"traceEvents": self.events(),
                "displayTimeUnit": "ms",
                "otherData": {"dropped_records": self.n_dropped,
                              "pid": self.pid}}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


def merge_traces(docs: list[dict]) -> dict:
    """Merge per-process Chrome trace docs into one (the dist contract:
    each process's recorder carried its own ``pid``, so concatenation IS
    the merge — lanes stay grouped per process in Perfetto)."""
    events: list[dict] = []
    dropped = 0
    for doc in docs:
        events.extend(doc.get("traceEvents", []))
        dropped += int(doc.get("otherData", {}).get("dropped_records", 0))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"dropped_records": dropped,
                          "merged_processes": len(docs)}}
