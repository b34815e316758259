"""Observability for the port: wave tracing + a typed metrics registry.

A copy of the reference package's ``obs`` (same names, same schema, same
stats keys), so the port's ``rads_enumerate`` emits exactly the stats
dict the reference emits.  Two halves — tracing (:mod:`.trace`) and
metrics (:mod:`.metrics` + the declared schema in :mod:`.schema`) —
joined by one rule: observability costs nothing when off and never
perturbs the engine when on.

* :class:`TraceRecorder` writes fixed-shape records into a preallocated
  ring (O(1) per span, oldest records dropped on wrap, drop count
  exported) and exports Chrome trace-event JSON for Perfetto.  Every
  timestamp comes from :func:`now_us`, the same clock the scheduler's
  ``*_wall_us`` stats use.  ``device_span`` bridges to
  ``torch.cuda.nvtx.range`` when asked, so CUDA profiles line up with the
  host lanes.
* The scheduler holds :data:`NULL_TRACER` unless a recorder is injected,
  and every hot-loop record site is guarded by ``tracer.enabled``; the
  recorder only ever takes host scalars, so it can never force a device
  synchronisation.
* :class:`MetricsRegistry` is a ``MutableMapping`` of typed
  :class:`Instrument` declarations behind the driver's ``stats``;
  ``to_stats()`` snapshots the plain dict the driver returns.

This package imports nothing from :mod:`repro_torch.core` (``torch`` is
imported lazily only inside ``device_span``), so every core module may
import it without cycles.
"""
from __future__ import annotations

from repro_torch.obs.metrics import (COUNTER, GAUGE, HISTOGRAM, INFO, UNSET,
                               Instrument, MetricsRegistry)
from repro_torch.obs.schema import build_driver_registry
from repro_torch.obs.trace import (NULL_TRACER, TRACK_PREWARM, TRACK_RETIRE,
                             TRACK_SCHED, TRACK_WAVE0, NullTracer,
                             TraceRecorder, merge_traces, now_us)

__all__ = [
    "COUNTER", "GAUGE", "HISTOGRAM", "INFO", "UNSET",
    "Instrument", "MetricsRegistry", "build_driver_registry",
    "NULL_TRACER", "NullTracer", "TraceRecorder", "merge_traces", "now_us",
    "TRACK_SCHED", "TRACK_RETIRE", "TRACK_PREWARM", "TRACK_WAVE0",
]
