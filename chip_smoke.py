"""Chip smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Drives the port (``src/repro_torch``) on one CUDA card and fails unless
every phase holds:

1. device   — the card's name and power limit (``nvidia-smi``), torch and
              CUDA versions;
2. build    — every CUDA kernel of the port (membership, intersect,
              delta_vlen), compiled from the repository's sources (one
              ``nvcc`` per source, all started together);
3. kernels  — each kernel's wrapper against its plain PyTorch version on
              the card, bit-exact, at the test sweep shapes, edge cases and
              the full-scale engine shapes, with its time beside its bound,
              the plain version's and the library yardstick's;
4. small    — ``rads_enumerate`` on a small graph, q1..q8: embeddings equal
              the brute-force oracle, every stat equals the port's own CPU
              run, cache on/off conserves fetch bytes, depth 1 == depth 2;
              and the same for bucketed storage with the varint wire;
5. full     — two runs of q1 on a DBLP-sized power-law graph (310,000
              vertices; com-DBLP has 317,080, see ``SMOKE_N``), each held
              against an independent scipy triangle count, with every
              kernel's launch count read around the run: the main path
              (``sim``, default ``EngineConfig``: dense, raw wire, cache
              on, depth 2), then bucketed storage with the varint wire,
              whose raw-equivalent byte counts must equal the first run's.

Each phase prints one JSON line.  Then come the kernels line, the
``nvidia-smi`` name/power line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
result lines.  Exits non-zero without a result when CUDA is missing or the
repository's ``src/`` is not beside this file.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM published HBM3 rate
ALU_OPS_PER_S = 67e12         # H100 SXM published non-tensor 32-bit rate
SMALL_CAPS = dict(frontier_cap=1 << 12, fetch_cap=256, verify_cap=1024,
                  region_group_budget=1 << 11)
FULL_N = 317_080              # com-DBLP's vertex count
# The full phase runs a slightly smaller graph.  At FULL_N, q1 escalates
# the capacities four times (its largest hub lands on a device that does
# not own it, so every pair of its neighbours is a frontier row and a
# verifyE pair for one peer).  At the fourth rung the static fetch
# buffers, (8, 8, 65,536, 1,796) int32 = 28 GiB, stay resident through the
# leaf steps on (2^20, 1,796) tensors, and the 80 GB card runs out
# (`--full-n 317080` shows it).  At 310,000 three escalations suffice.
SMOKE_N = 310_000
SMOKE_MAX_DEGREE = 1780       # max degree of powerlaw_graph(SMOKE_N, 6, 1)
CUT_REASON = ("at n=317,080 the fourth capacity escalation (28 GiB fetch "
              "buffers held through 2^20-row leaf steps) runs out of device "
              "memory; 310,000 needs three escalations")
DEVICE = "cuda"
TIMING_KEYS = {"compiles", "compile_s", "compile_cache_hits", "wave_s_total",
               "sme_wall_us", "dist_wall_us", "wall_us", "sme_pipeline_s",
               "dist_pipeline_s", "exec_cache_enabled"}


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------- #
# phase 1: device
# --------------------------------------------------------------------------- #
def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    emit(phase="device", name=torch.cuda.get_device_name(0),
         nvidia_smi=smi_line, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return smi_line


# --------------------------------------------------------------------------- #
# phase 2: build
# --------------------------------------------------------------------------- #
def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.intersect import kernel as inter_kernel
    from repro_torch.kernels.membership import kernel as memb_kernel
    from repro_torch.kernels.varint import kernel as varint_kernel
    sources = [memb_kernel.SOURCE, inter_kernel.SOURCE, varint_kernel.SOURCE]
    t0 = time.perf_counter()
    took = build.build(sources)
    wall = time.perf_counter() - t0
    ptxas = {}
    for src in sources:
        log = build.library_path(src).with_suffix(".log")
        ptxas[src.name] = ([ln for ln in log.read_text().splitlines()
                            if "registers" in ln or "spill" in ln]
                           if log.is_file() else [])
    emit(phase="build", wall_s=wall,
         built={s.name: t for s, t in took.items()}, ptxas=ptxas)


# --------------------------------------------------------------------------- #
# phase 3: kernel vs plain version
# --------------------------------------------------------------------------- #
def _sorted_probes(M: int) -> int:
    """Entries a lower_bound over M sorted ids reads, at most."""
    return math.ceil(math.log2(M)) + 1 if M > 1 else 1


def _membership_bound_ms(B: int, M: int, K: int) -> tuple[float, str]:
    """Least time for the membership function on these shapes: queries
    read once, answers written once, and of each row what a search must
    read — the whole row when it is smaller than one 32-byte sector per
    probe per query; compares counted at the 32-bit ALU rate."""
    probes = _sorted_probes(M)
    row_bytes = B * min(4 * M, K * probes * 32)
    nbytes = B * K * 4 + B * K * 1 + row_bytes
    ops = B * K * probes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sorted_rows(gen, B, M, hi, sentinel, device, pad=True):
    """Sentinel-padded sorted rows with a spread of degrees (the engine's
    adjacency windows), generated on the card."""
    import torch
    rows = torch.randint(0, hi, (B, M), generator=gen, device=device,
                         dtype=torch.int32)
    rows = torch.sort(rows, dim=1).values
    if pad:
        deg = torch.randint(1, M + 1, (B, 1), generator=gen, device=device)
        col = torch.arange(M, device=device)
        rows = torch.where(col < deg, rows, torch.full_like(rows, sentinel))
    return rows


def engine_shapes(max_degree: int) -> dict:
    """The membership shapes the full-scale phase launches at the default
    caps: the engine runs the devices in chunks of at most
    ``CHUNK_ELEMS`` elements of a (rows, max_degree) tensor."""
    from repro_torch.configs.rads import DEFAULT_ENGINE as cfg
    from repro_torch.core.engine import _device_chunks
    nd, D = 8, max_degree
    t0, t1 = _device_chunks(nd, cfg.frontier_cap * D)[0]
    v0, v1 = _device_chunks(nd, nd * cfg.verify_cap * D)[0]
    return {
        # back-edge filter: B = devices * frontier_cap, M = K = max_degree
        "backedge": ((t1 - t0) * cfg.frontier_cap, D, D, SMOKE_N),
        # verifyE answer: B = devices * ndev * verify_cap, M = D, K = 1
        "verify": ((v1 - v0) * nd * cfg.verify_cap, D, 1, SMOKE_N),
    }


def phase_kernels(full_shapes):
    import torch
    from repro_torch.kernels.membership import ops
    from repro_torch.kernels.membership.ref import membership_ref
    dev = torch.device("cuda")
    cases = []
    for B, M, K in [(7, 16, 3), (64, 130, 9), (256, 64, 1), (3, 257, 17)]:
        rng = np.random.default_rng(B * M + K)          # the test sweep
        rows = np.sort(rng.integers(0, 300, (B, M)).astype(np.int32), axis=1)
        vals = rng.integers(0, 300, (B, K)).astype(np.int32)
        cases.append((f"sweep_{B}x{M}x{K}", torch.as_tensor(rows, device=dev),
                      torch.as_tensor(vals, device=dev)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sent = 1000
    full = _sorted_rows(gen, 300, 40, sent, sent, dev, pad=False)
    cases.append(("full_rows_no_sentinel", full,
                  torch.randint(-5, sent + 5, (300, 7), generator=gen,
                                device=dev, dtype=torch.int32)))
    padded = _sorted_rows(gen, 300, 40, sent, sent, dev)
    cases.append(("sentinel_queries", padded,
                  torch.full((300, 5), sent, device=dev, dtype=torch.int32)))
    cases.append(("m_is_1", _sorted_rows(gen, 513, 1, 4, 4, dev, pad=False),
                  torch.randint(0, 5, (513, 3), generator=gen, device=dev,
                                dtype=torch.int32)))
    cases.append(("b_not_block_multiple",
                  _sorted_rows(gen, 1001, 33, 100, 100, dev),
                  torch.randint(0, 101, (1001, 3), generator=gen, device=dev,
                                dtype=torch.int32)))
    for name, rows, vals in cases:
        got = ops.membership(rows, vals)
        want = membership_ref(rows, vals)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"membership {name} disagrees")
    emit(phase="kernels", kernel="membership", exact_cases=[c[0] for c in
                                                             cases])

    results = {}
    for name, (B, M, K, n) in full_shapes.items():
        rows = _sorted_rows(gen, B, M, n, n, dev)
        # queries: half drawn from the rows (members), half uniform
        pick = torch.randint(0, M, (B, K), generator=gen, device=dev)
        vals = torch.where(
            torch.rand((B, K), generator=gen, device=dev) < 0.5,
            torch.gather(rows, 1, pick),
            torch.randint(0, n + 1, (B, K), generator=gen, device=dev,
                          dtype=torch.int32))
        got = ops.membership(rows, vals)
        want = membership_ref(rows, vals)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"membership {name} disagrees")
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        del got, want
        kernel_ms = cuda_ms(lambda: ops.membership(rows, vals))
        plain_ms = cuda_ms(lambda: membership_ref(rows, vals), iters=3)
        library_ms = cuda_ms(lambda: torch.gather(
            rows, 1, torch.searchsorted(rows, vals).clamp_(max=M - 1))
            == vals, iters=3)
        bound_ms, bound_by = _membership_bound_ms(B, M, K)
        results[name] = dict(B=B, M=M, K=K, max_abs_err=err,
                             kernel_ms=kernel_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
        emit(phase="kernels", kernel="membership", shape=name,
             **results[name])
        del rows, vals, pick
        torch.cuda.empty_cache()
    return results


def _intersect_bound_ms(a, sentinel: int) -> tuple[float, str]:
    """Least time for the intersect function on these inputs: ``a`` read
    once, the mask and the counts written once, and of each ``b`` row what
    the searches of its non-sentinel queries must read (the whole row at
    most); compares counted at the 32-bit ALU rate."""
    import torch
    B, M = a.shape
    probes = _sorted_probes(M)
    live = (a != sentinel).sum(dim=1, dtype=torch.int64)
    b_bytes = int(torch.clamp(live * (probes * 32), max=4 * M).sum())
    nbytes = B * M * 4 + B * M + B * 4 + b_bytes
    ops = int(live.sum()) * probes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _intersect_inputs(gen, B, M, n, dev, degrees=None):
    """Candidate windows ``a`` and back-edge rows ``b`` like the bucketed
    back-edge filter's: sorted ids padded with the sentinel ``n`` past a
    degree drawn from ``degrees`` (full rows when None), about half of
    ``a``'s ids taken from ``b``'s row."""
    import torch
    col = torch.arange(M, device=dev, dtype=torch.int32)

    def degree():
        if degrees is None:
            return torch.full((B, 1), M, device=dev, dtype=torch.int32)
        pick = torch.randint(0, degrees.numel(), (B, 1), generator=gen,
                             device=dev)
        return degrees[pick].clamp_(1, M)

    deg_b = degree()
    b = _sorted_rows(gen, B, M, n, n, dev, pad=False)
    b = torch.where(col < deg_b, b, n)
    take = (torch.rand((B, M), generator=gen, device=dev) * deg_b).long()
    a = torch.gather(b, 1, take.clamp_(max=M - 1))
    del take
    fresh = torch.randint(0, n, (B, M), generator=gen, device=dev,
                          dtype=torch.int32)
    a = torch.where(torch.rand((B, M), generator=gen, device=dev) < 0.5, a,
                    fresh)
    del fresh
    a = torch.sort(a, dim=1).values
    a = torch.where(col < degree(), a, n)
    return a.contiguous(), b.contiguous()


def phase_intersect(degrees, n: int, max_degree: int):
    """The intersect kernel against its plain version: the reference
    sweep, sentinel-padded windows and edges, then the bucketed back-edge
    filter's shape (B = devices * frontier_cap rows of max_degree) with
    rows padded by the full graph's degree distribution and with full
    rows, timed beside its bound and the searchsorted+gather yardstick."""
    import torch
    from repro_torch.configs.rads import DEFAULT_ENGINE as cfg
    from repro_torch.core.engine import _device_chunks
    from repro_torch.kernels.intersect import ops
    from repro_torch.kernels.intersect.ref import intersect_ref
    dev = torch.device("cuda")
    cases = []
    for B, M in [(5, 20), (33, 129), (128, 64), (17, 8), (40, 65), (9, 200)]:
        rng = np.random.default_rng(B + M)              # the test sweep
        a = np.sort(rng.integers(0, 500, (B, M)).astype(np.int32), axis=1)
        b = np.sort(rng.integers(0, 500, (B, M)).astype(np.int32), axis=1)
        cases.append((f"sweep_{B}x{M}", torch.as_tensor(a, device=dev),
                      torch.as_tensor(b, device=dev), 500))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    small_deg = torch.randint(0, 41, (64,), generator=gen, device=dev)
    for name, B, M, d in [("padded_300x40", 300, 40, small_deg),
                          ("full_rows_300x40", 300, 40, None),
                          ("m_is_1", 513, 1, small_deg),
                          ("b_not_block_multiple", 1001, 33, small_deg)]:
        cases.append((name, *_intersect_inputs(gen, B, M, 1000, dev, d),
                      1000))
    for name, a, b, sent in cases:
        got = ops.intersect(a, b, sent)
        want = intersect_ref(a, b, sent)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"intersect {name} disagrees")
    emit(phase="kernels", kernel="intersect",
         exact_cases=[c[0] for c in cases])

    t0, t1 = _device_chunks(8, cfg.frontier_cap * max_degree)[0]
    B, M = (t1 - t0) * cfg.frontier_cap, max_degree
    degrees = torch.as_tensor(degrees, device=dev, dtype=torch.int32)
    results = {}
    for name, d in (("backedge_padded", degrees), ("backedge_full", None)):
        a, b = _intersect_inputs(gen, B, M, n, dev, d)
        got = ops.intersect(a, b, n)
        want = intersect_ref(a, b, n)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"intersect {name} disagrees")
        err = max(int((got[0].to(torch.int32) - want[0].to(torch.int32))
                      .abs().max()),
                  int((got[1] - want[1]).abs().max()))
        del got, want
        kernel_ms = cuda_ms(lambda: ops.intersect(a, b, n))
        plain_ms = cuda_ms(lambda: intersect_ref(a, b, n), iters=3)
        library_ms = cuda_ms(lambda: torch.gather(
            b, 1, torch.searchsorted(b, a).clamp_(max=M - 1)) == a, iters=3)
        bound_ms, bound_by = _intersect_bound_ms(a, n)
        results[name] = dict(B=B, M=M, max_abs_err=err, kernel_ms=kernel_ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             live_share=float((a != n).float().mean()))
        emit(phase="kernels", kernel="intersect", shape=name,
             **results[name])
        del a, b
        torch.cuda.empty_cache()
    return results


def _id_lanes(gen, B, M, n, dev, hole_p=0.3):
    """Fetch request lanes: ascending ids below ``n`` with sentinel holes
    (cache hits and unused slots)."""
    import torch
    ids = torch.sort(torch.randint(0, n, (B, M), generator=gen, device=dev,
                                   dtype=torch.int32), dim=1).values
    holes = torch.rand((B, M), generator=gen, device=dev) < hole_p
    return ids.masked_fill_(holes, n)


def phase_delta_vlen(n: int, fetch_caps: tuple):
    """The delta_vlen kernel against its plain version: the reference
    sweep (ids up to 2^27) and edges, then the fetch encoder's shapes
    (ndev * ndev = 64 lanes of the default and the escalated fetch cap),
    timed beside its bound; no one PyTorch call computes it."""
    import torch
    from repro_torch.kernels.varint import ops
    from repro_torch.kernels.varint.ref import delta_vlen_ref
    dev = torch.device("cuda")
    cases = []
    for B, M in [(3, 16), (7, 130), (260, 64), (1, 300)]:
        rng = np.random.default_rng(B * M)              # the test sweep
        big = 1 << 27
        ids = np.full((B, M), big, np.int32)
        for r in range(B):
            k = int(rng.integers(0, M + 1))
            vals = np.sort(rng.choice(big, size=k, replace=False))
            ids[r, np.sort(rng.choice(M, k, replace=False))] = vals
        cases.append((f"sweep_{B}x{M}", torch.as_tensor(ids, device=dev), big))
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    cases.append(("long_rows_5x4099", _id_lanes(gen, 5, 4099, 1 << 30, dev),
                  1 << 30))
    cases.append(("all_holes", torch.full((4, 70), 9, device=dev,
                                          dtype=torch.int32), 9))
    cases.append(("unsorted", torch.randint(0, 1 << 29, (9, 333),
                                            generator=gen, device=dev,
                                            dtype=torch.int32), 1 << 29))
    for name, ids, sent in cases:
        got = ops.delta_vlen(ids, sent)
        want = delta_vlen_ref(ids, sent)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"delta_vlen {name} disagrees")
    emit(phase="kernels", kernel="delta_vlen",
         exact_cases=[c[0] for c in cases])

    results = {}
    for fcap in fetch_caps:
        ids = _id_lanes(gen, 64, fcap, n, dev)
        got = ops.delta_vlen(ids, n)
        want = delta_vlen_ref(ids, n)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"delta_vlen 64x{fcap} disagrees")
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        kernel_ms = cuda_ms(lambda: ops.delta_vlen(ids, n), iters=50)
        plain_ms = cuda_ms(lambda: delta_vlen_ref(ids, n), iters=10)
        # one int32 read and two int32 writes per id; the compares are
        # a handful of 32-bit operations per id
        t_bytes = ids.numel() * 12 / HBM_BYTES_PER_S * 1e3
        t_ops = ids.numel() * 12 / ALU_OPS_PER_S * 1e3
        bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                              else (t_ops, "operations"))
        results[fcap] = dict(B=64, M=fcap, max_abs_err=err,
                             kernel_ms=kernel_ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=bound_ms,
                             bound_by=bound_by)
        emit(phase="kernels", kernel="delta_vlen", shape=f"64x{fcap}",
             **results[fcap])
    return results


# --------------------------------------------------------------------------- #
# phase 4: small graph, oracle parity on the card
# --------------------------------------------------------------------------- #
def phase_small():
    from repro_torch.configs.rads import QUERIES, EngineConfig
    from repro_torch.core import (Pattern, canonicalize, enumerate_oracle,
                                  rads_enumerate)
    from repro_torch.graph import erdos_graph, partition
    g = erdos_graph(120, 5.0, seed=5)
    pg = partition(g, 8, method="bfs")
    counts, wire = {}, {}
    for q, edges in QUERIES.items():
        pat = Pattern.from_edges(edges)
        oracle = canonicalize(enumerate_oracle(g, pat), pat)
        runs = {}
        for cache in (True, False):
            for depth in (1, 2):
                cfg = EngineConfig(**SMALL_CAPS, enable_cache=cache,
                                   pipeline_depth=depth)
                runs[cache, depth] = rads_enumerate(pg, pat, cfg,
                                                    device=DEVICE)
        cpu = rads_enumerate(pg, pat, EngineConfig(**SMALL_CAPS),
                             device="cpu")
        on, off = runs[True, 2], runs[False, 2]
        check(canonicalize(on.embeddings, pat) == oracle,
              f"{q}: embeddings differ from the oracle")
        for key in set(on.stats) | set(cpu.stats):
            if key not in TIMING_KEYS:
                check(on.stats.get(key) == cpu.stats.get(key),
                      f"{q}: stat {key} differs between cuda and cpu: "
                      f"{on.stats.get(key)!r} vs {cpu.stats.get(key)!r}")
        check(on.stats["bytes_fetch"] + on.stats["bytes_saved_cache"]
              == off.stats["bytes_fetch"],
              f"{q}: cache on/off does not conserve fetch bytes")
        for cache in (True, False):
            d1, d2 = runs[cache, 1], runs[cache, 2]
            check(d1.count == d2.count and d1.embeddings == d2.embeddings,
                  f"{q}: depth 1 and depth 2 disagree")
            for key in ("bytes_fetch", "bytes_verify", "bytes_saved_cache",
                        "cache_hits", "cache_probes"):
                check(d1.stats[key] == d2.stats[key],
                      f"{q}: depth 1/2 differ on {key}")
        counts[q] = on.count

        # bucketed storage with the varint wire, on the card and the CPU
        fmt_cfg = EngineConfig(**SMALL_CAPS, storage_format="bucketed",
                               wire_format="varint")
        bv = rads_enumerate(pg, pat, fmt_cfg, device=DEVICE)
        bv_cpu = rads_enumerate(pg, pat, fmt_cfg, device="cpu")
        check(canonicalize(bv.embeddings, pat) == oracle,
              f"{q}: bucketed/varint embeddings differ from the oracle")
        for key in set(bv.stats) | set(bv_cpu.stats):
            if key not in TIMING_KEYS:
                check(bv.stats.get(key) == bv_cpu.stats.get(key),
                      f"{q}: bucketed/varint stat {key} differs between "
                      f"cuda and cpu: {bv.stats.get(key)!r} vs "
                      f"{bv_cpu.stats.get(key)!r}")
        for key in ("bytes_fetch", "bytes_verify", "bytes_saved_cache"):
            check(bv.stats[key] == on.stats[key],
                  f"{q}: bucketed/varint {key} differs from dense/raw")
        check(bv.stats["bytes_wire_fetch"] <= bv.stats["bytes_fetch"]
              and bv.stats["bytes_wire_verify"] <= bv.stats["bytes_verify"],
              f"{q}: varint wire bytes exceed the raw accounting")
        wire[q] = (bv.stats["bytes_wire_fetch"], bv.stats["bytes_wire_verify"])
    emit(phase="small", graph="erdos_graph(120, 5.0, seed=5) bfs/8",
         counts=counts, oracle_match=True,
         bucketed_varint_wire_bytes=wire)


# --------------------------------------------------------------------------- #
# phase 5: full scale
# --------------------------------------------------------------------------- #
def _triangles(g) -> int:
    """Independent triangle count: sum of (L @ L) ∘ L, L the strictly
    lower triangle of the adjacency matrix."""
    import scipy.sparse as sp
    a = sp.csr_matrix((np.ones(len(g.indices), dtype=np.int64),
                       g.indices, g.indptr), shape=(g.n, g.n))
    low = sp.tril(a, k=-1, format="csr")
    return int((low @ low).multiply(low).sum())


def phase_full(g, pg, expect: int, setup_s: float, storage: str,
               wire: str):
    """One full-scale q1 run in the given storage and wire formats, with
    every kernel's launch count set to 0 just before it and read just
    after.  Returns ``(launches, stats, max_memory_allocated)``."""
    import dataclasses

    import torch
    from repro_torch.configs.rads import DEFAULT_ENGINE, QUERIES
    from repro_torch.core import Pattern, rads_enumerate
    from repro_torch.kernels.intersect import ops as inter
    from repro_torch.kernels.membership import ops as memb
    from repro_torch.kernels.varint import ops as varint
    from repro_torch.obs import TraceRecorder
    kernels = {"membership": memb, "intersect": inter, "delta_vlen": varint}
    cfg = dataclasses.replace(DEFAULT_ENGINE, storage_format=storage,
                              wire_format=wire)
    pat = Pattern.from_edges(QUERIES["q1"])
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tracer = TraceRecorder(capacity=1 << 20)
    for mod in kernels.values():
        mod.launches = 0
    t0 = time.perf_counter()
    res = rads_enumerate(pg, pat, cfg, return_embeddings=False,
                         tracer=tracer, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    # host time per span kind: stages only enqueue work, so the time the
    # card needs shows up in the retire spans (the one copy per wave)
    spans: dict = {}
    for ph, name, _, _, dur, _, _ in tracer.records():
        if ph == "X" and not name.startswith("phase"):
            kind = name.split(":")[0]
            c, ms = spans.get(kind, (0, 0.0))
            spans[kind] = (c + 1, ms + dur / 1e3)
    st = res.stats
    tag = f"{storage}/{wire}"
    check(res.count == expect,
          f"full-scale q1 ({tag}) count {res.count} != scipy triangles "
          f"{expect}")
    check(launches["membership"] > 0,
          f"membership kernel never launched ({tag})")
    if storage == "bucketed":
        check(launches["intersect"] > 0, "intersect kernel never launched")
    if wire == "varint":
        check(launches["delta_vlen"] > 0, "delta_vlen kernel never launched")
    n = g.n
    emit(phase="full", storage=storage, wire=wire, n=n, published_n=FULL_N,
         cut=n != FULL_N, cut_reason=CUT_REASON if n == SMOKE_N else None,
         edges=g.n_edges, max_degree=g.max_degree, setup_s=setup_s,
         wall_s=wall, count=res.count, triangles_scipy=expect,
         launches=launches, n_waves=st["n_waves"], n_groups=st["n_groups"],
         sme_pipeline_s=st.get("sme_pipeline_s", 0.0),
         dist_pipeline_s=st.get("dist_pipeline_s", 0.0),
         overflow_retries=st["overflow_retries"],
         cap_escalations=st["cap_escalations"], final_caps=st["final_caps"],
         n_sme_seeds=st["n_sme_seeds"], n_dist_seeds=st["n_dist_seeds"],
         bytes_fetch=st["bytes_fetch"], bytes_verify=st["bytes_verify"],
         bytes_wire_fetch=st["bytes_wire_fetch"],
         bytes_wire_verify=st["bytes_wire_verify"],
         bytes_saved_cache=st["bytes_saved_cache"],
         cache_hit_rate=st["cache_hit_rate"],
         peak_adj_bytes=st["peak_adj_bytes"], max_memory_allocated=peak,
         host_span_count_ms=spans)
    return launches, st


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-n", type=int, default=SMOKE_N,
                    help=f"vertices of the full-scale graph (published: "
                         f"{FULL_N})")
    ap.add_argument("--skip-full", action="store_true",
                    help="stop after the small-graph phase, printing no "
                         "result (a short check of the build and kernels)")
    args = ap.parse_args()
    # growable segments instead of fixed blocks: the escalated stages
    # allocate and free tensors of several GB, which fragments fixed blocks
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, src)
    from repro_torch.configs.rads import DEFAULT_ENGINE
    from repro_torch.graph import partition, powerlaw_graph

    smi_line = phase_device()
    phase_build()
    # the full-scale graph: its shapes and degrees drive the kernel timings
    t0 = time.perf_counter()
    g = powerlaw_graph(args.full_n, 6, seed=1)
    pg = partition(g, 8, method="bfs")
    setup_s = time.perf_counter() - t0
    if args.full_n == SMOKE_N:
        check(g.max_degree == SMOKE_MAX_DEGREE,
              f"max degree {g.max_degree} != {SMOKE_MAX_DEGREE}")
    timing = phase_kernels(engine_shapes(g.max_degree))
    inter = phase_intersect(g.degrees, pg.n, g.max_degree)
    # the default fetch cap, and the cap after the run's three escalations
    fcaps = (DEFAULT_ENGINE.fetch_cap, DEFAULT_ENGINE.fetch_cap << 3)
    dvl = phase_delta_vlen(pg.n, fcaps)
    phase_small()
    if args.skip_full:
        return
    t0 = time.perf_counter()
    expect = _triangles(g)
    setup_s += time.perf_counter() - t0
    main_launches, dense = phase_full(g, pg, expect, setup_s, "dense", "raw")
    new_launches, coded = phase_full(g, pg, expect, setup_s, "bucketed",
                                     "varint")
    for key in ("bytes_fetch", "bytes_verify", "bytes_saved_cache"):
        check(coded[key] == dense[key],
              f"full-scale {key}: bucketed/varint {coded[key]} != "
              f"dense/raw {dense[key]}")
    check(coded["bytes_wire_verify"] < coded["bytes_verify"],
          "varint verifyE bytes are not below the raw accounting")
    emit(phase="full_compare", peak_adj_bytes={
        "dense": dense["peak_adj_bytes"],
        "bucketed": coded["peak_adj_bytes"]},
        bytes_wire_verify={"raw": dense["bytes_wire_verify"],
                           "varint": coded["bytes_wire_verify"]},
        bytes_wire_fetch={"raw": dense["bytes_wire_fetch"],
                          "varint": coded["bytes_wire_fetch"]})

    t, ti, td = timing["backedge"], inter["backedge_padded"], dvl[fcaps[-1]]
    rows = [
        ("membership", "src/repro_torch/kernels/membership/csrc/membership.cu",
         "src/repro/kernels/membership/kernel.py:40",
         main_launches["membership"], t),
        ("intersect", "src/repro_torch/kernels/intersect/csrc/intersect.cu",
         "src/repro/kernels/intersect/kernel.py:38",
         new_launches["intersect"], ti),
        ("delta_vlen", "src/repro_torch/kernels/varint/csrc/delta_vlen.cu",
         "src/repro/kernels/varint/kernel.py:67",
         new_launches["delta_vlen"], td)]
    emit(kernels=[dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=r["max_abs_err"], ms=r["kernel_ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"])
        for name, source, replaces, launches, r in rows])
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
