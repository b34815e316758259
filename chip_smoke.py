"""Chip smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Drives the port (``src/repro_torch``) on one CUDA card and fails unless
every phase holds:

1. device   — the card's name and power limit (``nvidia-smi``), torch and
              CUDA versions;
2. build    — every CUDA kernel of the main path, compiled from the
              repository's sources (one ``nvcc`` per source, all started
              together);
3. kernels  — each kernel's wrapper against its plain PyTorch version on
              the card, bit-exact, at the test sweep shapes, edge cases and
              the full-scale engine shapes, with its time beside its bound,
              the plain version's and the library yardstick's;
4. small    — ``rads_enumerate`` on a small graph, q1..q8: embeddings equal
              the brute-force oracle, every stat equals the port's own CPU
              run, cache on/off conserves fetch bytes, depth 1 == depth 2;
5. full     — the main path (``sim``, default ``EngineConfig``: dense,
              raw wire, cache on, depth 2) on a DBLP-sized power-law graph
              (310,000 vertices; com-DBLP has 317,080, see ``SMOKE_N``),
              q1, held against an independent scipy triangle count, with
              every kernel's launch count read around the run.

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
    from repro_torch.kernels.membership import kernel as memb_kernel
    sources = [memb_kernel.SOURCE]
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
def _membership_bound_ms(B: int, M: int, K: int) -> tuple[float, str]:
    """Least time for the membership function on these shapes: queries
    read once, answers written once, and of each row what a search must
    read — the whole row when it is smaller than one 32-byte sector per
    probe per query; compares counted at the 32-bit ALU rate."""
    probes = math.ceil(math.log2(M)) + 1 if M > 1 else 1
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
    counts = {}
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
    emit(phase="small", graph="erdos_graph(120, 5.0, seed=5) bfs/8",
         counts=counts, oracle_match=True)


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


def phase_full(n: int):
    import torch
    from repro_torch.configs.rads import DEFAULT_ENGINE, QUERIES
    from repro_torch.core import Pattern, rads_enumerate
    from repro_torch.graph import partition, powerlaw_graph
    from repro_torch.kernels.membership import ops as memb
    from repro_torch.obs import TraceRecorder
    t0 = time.perf_counter()
    g = powerlaw_graph(n, 6, seed=1)
    pg = partition(g, 8, method="bfs")
    expect = _triangles(g)
    setup_s = time.perf_counter() - t0
    if n == SMOKE_N:     # phase 3 timed the kernel at this graph's shapes
        check(g.max_degree == SMOKE_MAX_DEGREE,
              f"max degree {g.max_degree} != {SMOKE_MAX_DEGREE}")
    pat = Pattern.from_edges(QUERIES["q1"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tracer = TraceRecorder(capacity=1 << 20)
    memb.launches = 0
    t0 = time.perf_counter()
    res = rads_enumerate(pg, pat, DEFAULT_ENGINE, return_embeddings=False,
                         tracer=tracer, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"membership": memb.launches}
    # host time per span kind: stages only enqueue work, so the time the
    # card needs shows up in the retire spans (the one copy per wave)
    spans: dict = {}
    for ph, name, _, _, dur, _, _ in tracer.records():
        if ph == "X" and not name.startswith("phase"):
            kind = name.split(":")[0]
            c, ms = spans.get(kind, (0, 0.0))
            spans[kind] = (c + 1, ms + dur / 1e3)
    st = res.stats
    check(res.count == expect,
          f"full-scale q1 count {res.count} != scipy triangles {expect}")
    check(launches["membership"] > 0, "membership kernel never launched")
    emit(phase="full", n=n, published_n=FULL_N, cut=n != FULL_N,
         cut_reason=CUT_REASON if n == SMOKE_N else None, edges=g.n_edges,
         max_degree=g.max_degree, setup_s=setup_s, wall_s=wall,
         count=res.count, triangles_scipy=expect, launches=launches,
         n_waves=st["n_waves"], n_groups=st["n_groups"],
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
         peak_adj_bytes=st["peak_adj_bytes"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
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

    smi_line = phase_device()
    phase_build()
    full_shapes = engine_shapes(SMOKE_MAX_DEGREE)
    timing = phase_kernels(full_shapes)
    phase_small()
    if args.skip_full:
        return
    launches, _ = phase_full(args.full_n)
    t = timing["backedge"]
    emit(kernels=[dict(
        name="membership", route="cuda",
        source="src/repro_torch/kernels/membership/csrc/membership.cu",
        replaces="src/repro/kernels/membership/kernel.py:40",
        launches=launches["membership"], max_abs_err=t["max_abs_err"],
        ms=t["kernel_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"])])
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
