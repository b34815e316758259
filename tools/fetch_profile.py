"""Where the varint fetch path of the PyTorch port spends its time, by op.

    python3 tools/fetch_profile.py [--src DIR] [--n 310000] [--window 3]

Runs q1 with bucketed storage and the varint wire on
``powerlaw_graph(n, 6, seed=1)``, 8-way bfs (``chip_smoke.py``'s full
cell) on one CUDA card, with the port imported from ``--src`` (default:
this checkout's ``src``; give an unpacked older commit's ``src`` to
measure it in the same call), and prints one JSON line: the run's wall
and peak memory, the host time of each stage span, and a
``torch.profiler`` window (host and device) over ``--window`` fetch
stages from the first one at the top fetch capacity (``--window-cap``,
default the cell's after its three escalations), each op of the fetch
path wrapped in a ``record_function`` range: the ids codec, the owners'
answer, the row codec, the requester's scatter, the whole fetch and
verifyE stages.  The window's edges synchronise the card, so the wall
includes them; a whole run under the profiler takes too long.  The
count is held against scipy's triangle count.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (module, attribute, label): the fetch path's ops, outermost first
WRAPPED = (
    ("scheduler", "fetch_stage", "fetch.stage"),
    ("engine", "fetch_exchange", "fetch.exchange"),
    ("wire", "encode_ids_lanes", "fetch.encode_ids"),
    ("wire", "decode_ids_lanes", "fetch.decode_ids"),
    ("engine", "_fetch_answer", "fetch.answer"),
    ("wire", "encode_rows_lanes", "fetch.encode_rows"),
    ("wire", "decode_rows_lanes", "fetch.decode_rows"),
    ("wire", "scatter_compacted_lanes", "fetch.scatter_compacted"),
    ("engine", "verify_exchange", "verify.exchange"),
    ("wire", "encode_pairs_lanes", "verify.encode_pairs"),
    ("wire", "decode_pairs_lanes", "verify.decode_pairs"),
)


def _triangles(g) -> int:
    import scipy.sparse as sp
    a = sp.csr_matrix((np.ones(len(g.indices), dtype=np.int64),
                       g.indices, g.indptr), shape=(g.n, g.n))
    low = sp.tril(a, k=-1, format="csr")
    return int((low @ low).multiply(low).sum())


def _wrap(label: str, fn):
    import torch

    @functools.wraps(fn)
    def inner(*args, **kw):
        with torch.profiler.record_function(label):
            return fn(*args, **kw)
    return inner


def _span_ms(tracer) -> dict:
    spans: dict = {}
    for ph, name, _, _, dur, _, _ in tracer.records():
        if ph == "X" and not name.startswith("phase"):
            kind = name.split(":")[0]
            c, ms = spans.get(kind, (0, 0.0))
            spans[kind] = (c + 1, ms + dur / 1e3)
    return spans


class _Window:
    """Profiles ``k`` fetch stages from the first at ``cap`` or above."""

    def __init__(self, cap: int, k: int):
        self.cap, self.k, self.n = cap, k, 0
        self.prof = self.wall = self.t0 = None

    def on_fetch(self, cfg) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        if self.prof is None and self.k and cfg.fetch_cap >= self.cap:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()
        elif self.prof is not None and self.wall is None:
            self.n += 1
            if self.n >= self.k:
                self.stop()

    def stop(self) -> None:
        import torch
        if self.prof is None or self.wall is not None:
            return
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.prof.stop()


def _split(prof, wall_s: float) -> dict:
    """Host and device ms of each wrapped range, busy and idle share of
    the window, and the top kernels."""
    from torch.autograd import DeviceType
    ranges, kern = {}, []
    labels = {label for _, _, label in WRAPPED}
    for e in prof.key_averages():
        on_card = getattr(e, "device_type", None) == DeviceType.CUDA
        if e.key in labels:
            r = ranges.setdefault(e.key, {})
            dev_ms = getattr(e, "device_time_total",
                             getattr(e, "cuda_time_total", 0.0)) / 1e3
            if on_card:     # the range's span on the card's timeline
                r["device_span_ms"] = dev_ms
            else:           # host time, and the device time of its kernels
                r.update(calls=e.count, host_ms=e.cpu_time_total / 1e3,
                         device_ms=dev_ms)
        elif on_card:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            kern.append((e.key[:80], us / 1e3, e.count))
    kern.sort(key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in kern)
    return dict(wall_ms=wall_s * 1e3, busy_ms=busy,
                idle_share=1 - busy / (wall_s * 1e3),
                ranges={k: ranges[k] for _, _, k in WRAPPED if k in ranges},
                top=[dict(kernel=k, ms=ms, count=c)
                     for k, ms, c in kern[:15]])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--n", type=int, default=310_000)
    ap.add_argument("--tag", default="")
    ap.add_argument("--window", type=int, default=3,
                    help="fetch stages to profile (0: none)")
    ap.add_argument("--window-cap", type=int, default=None,
                    help="fetch capacity at which the window opens "
                         "(default: the engine's default << 3)")
    args = ap.parse_args()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        sys.exit("fetch_profile: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.src))
    import dataclasses

    from repro_torch.configs.rads import DEFAULT_ENGINE, QUERIES
    from repro_torch.core import Pattern, engine, rads_enumerate, scheduler
    from repro_torch.core import wire
    from repro_torch.graph import partition, powerlaw_graph
    from repro_torch.obs import TraceRecorder

    mods = {"engine": engine, "wire": wire, "scheduler": scheduler}
    g = powerlaw_graph(args.n, 6, seed=1)
    pg = partition(g, 8, method="bfs")
    expect = _triangles(g)
    cfg = dataclasses.replace(DEFAULT_ENGINE, storage_format="bucketed",
                              wire_format="varint")
    pat = Pattern.from_edges(QUERIES["q1"])
    window = _Window(args.window_cap or DEFAULT_ENGINE.fetch_cap << 3,
                     args.window)
    for mod, name, label in WRAPPED:
        setattr(mods[mod], name, _wrap(label, getattr(mods[mod], name)))
    stage = scheduler.fetch_stage

    def fetch_stage(g_, pd, cfg_, *a, **kw):
        window.on_fetch(cfg_)
        return stage(g_, pd, cfg_, *a, **kw)

    scheduler.fetch_stage = fetch_stage
    tracer = TraceRecorder(capacity=1 << 20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = rads_enumerate(pg, pat, cfg, return_embeddings=False,
                         tracer=tracer, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    window.stop()
    if res.count != expect:
        sys.exit(f"fetch_profile: count {res.count} != scipy {expect}")
    st = res.stats
    out = dict(tag=args.tag, src=args.src, n=g.n,
               card=torch.cuda.get_device_name(0), wall_s=wall,
               count=res.count, peak=torch.cuda.max_memory_allocated(),
               bytes_wire_fetch=st["bytes_wire_fetch"],
               bytes_wire_verify=st["bytes_wire_verify"],
               cap_escalations=st["cap_escalations"], n_waves=st["n_waves"],
               host_span_count_ms=_span_ms(tracer))
    if window.prof is not None:
        out["window"] = dict(fetch_stages=window.k, cap=window.cap,
                             **_split(window.prof, window.wall))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
