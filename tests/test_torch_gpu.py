"""Card-only tests of the PyTorch port: the hand-written CUDA kernels
(membership, intersect, the varint fetch codec's encoders and decoder
with delta_vlen, flash_attn and moe_gemm with their backward kernels,
segment_spmm in both its variants and their backward kernels) against
their plain PyTorch versions, the whole engine on the card — dense and
bucketed storage, raw and varint wire, and two ``dist`` ranks sharing the
card — the reduced OLMoE serving path
and training step the four reduced GNNs' forward and training step, and reduced DIN's
training step, against the port's CPU path.
They skip without a CUDA card, and import no JAX, so they run where
only PyTorch is installed:
``PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py``."""
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from _gnn_cases import (ALL_MASKED_NODE, D_FEAT, GAT_BF16_TOL,
                        GAT_HEAD_SHAPES, GNN_ARCHS, HUB_NODE, N_OUT,
                        SPMM_EDGE_CASES, SPMM_SWEEP, SPMM_TOL,
                        gat_kernel_inputs, graph_arrays)
from _gnn_cases import edge_inputs as spmm_edge_inputs
from _gnn_cases import sweep_inputs as spmm_sweep_inputs
from _codec_cases import (ARBITRARY_STREAM_SEEDS, CODEC_ID_CASES,
                          CODEC_ROW_CASES, DELTA_VLEN_SWEEP,
                          INTERSECT_CARD_CASES, INTERSECT_CASES,
                          arbitrary_row_streams, delta_vlen_inputs,
                          intersect_inputs)
from _lm_cases import (FLASH_SWEEP, FLASH_TOL, MOE_ROW_CHECK, MOE_SWEEP,
                       MOE_TOL, flash_inputs, moe_inputs)
from _dist_rank import run_spawned
from _membership_cases import CARD_CASES, CASES, edge_inputs, sweep_inputs
from repro_torch.configs import get_reduced
from repro_torch.configs.rads import QUERIES, EngineConfig
from repro_torch.convert import graph_batch_from_arrays
from repro_torch.core import Pattern, rads_enumerate
from repro_torch.graph import erdos_graph, partition
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.flash_attn.ref import flash_attention_bwd_ref
from repro_torch.kernels.intersect import ops as intersect_ops
from repro_torch.kernels.intersect.kernel import intersect_cuda
from repro_torch.kernels.intersect.ref import intersect_ref
from repro_torch.kernels.membership import ops
from repro_torch.kernels.membership.kernel import membership_cuda
from repro_torch.kernels.membership.ref import membership_ref
from repro_torch.kernels.moe_gemm import kernel as moe_kernel
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.kernels.moe_gemm.ref import (bound_ratio, moe_down_ref,
                                              moe_gemm_bwd_ref, moe_gemm_f64,
                                              moe_gemm_ref, moe_hidden_ref)
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.kernels.varint import ops as varint_ops
from repro_torch.kernels.varint import ref as varint_ref
from repro_torch.kernels.varint.ref import delta_vlen_ref
from repro_torch.models import (decode_step, gnn_forward, init_gnn,
                                init_lm_params, lm_loss, prefill)

CAPS = dict(frontier_cap=1 << 12, fetch_cap=256, verify_cap=1024,
            region_group_budget=1 << 11)
# wall-clock timings, and the compile group: the card captures its stages
# as CUDA graphs where the CPU and ``dist`` run them eagerly
TIMING_KEYS = {"wave_s_total", "sme_wall_us", "dist_wall_us", "wall_us",
               "sme_pipeline_s", "dist_pipeline_s", "compiles", "compile_s",
               "compile_cache_hits", "exec_cache_enabled", "exec_cache"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind,arg", CASES + CARD_CASES)
def test_kernel_matches_plain_on_card(cuda, kind, arg):
    rows, vals = sweep_inputs(*arg) if kind == "sweep" else edge_inputs(arg)
    rows = torch.as_tensor(rows, device=cuda)
    vals = torch.as_tensor(vals, device=cuda)
    before = ops.launches
    got = ops.membership(rows, vals)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert torch.equal(got, membership_ref(rows, vals))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,arg", CASES + CARD_CASES)
@pytest.mark.parametrize("path", ["row", "query"])
def test_membership_paths_match_plain_on_card(cuda, kind, arg, path):
    """Each case through both of the kernel's paths, whatever K is, on
    windows at an offset that breaks 16-byte alignment too."""
    rows, vals = sweep_inputs(*arg) if kind == "sweep" else edge_inputs(arg)
    K = vals.shape[1]
    for offset in (0, 1):
        r, v, out = (_at_offset(torch.as_tensor(x, device=cuda), offset)
                     for x in (rows, vals, np.zeros(vals.shape, bool)))
        membership_cuda(r, v, out, 1 if path == "row" else K + 1)
        torch.cuda.synchronize()
        assert torch.equal(out, membership_ref(r, v)), offset


def _at_offset(t, offset):
    """A contiguous copy of ``t`` that starts ``offset`` elements into its
    allocation: at 1, no longer 16-byte aligned."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    return buf[offset:].view(t.shape).copy_(t)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,shape", INTERSECT_CASES + INTERSECT_CARD_CASES)
def test_intersect_kernel_matches_plain_on_card(cuda, kind, shape):
    a, b, sent = intersect_inputs(kind, *shape)
    a = torch.as_tensor(a, device=cuda)
    b = torch.as_tensor(b, device=cuda)
    before = intersect_ops.launches
    mask, count = intersect_ops.intersect(a, b, sent)
    torch.cuda.synchronize()
    assert intersect_ops.launches == before + 1
    want_mask, want_count = intersect_ref(a, b, sent)
    assert torch.equal(mask, want_mask) and torch.equal(count, want_count)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,shape", INTERSECT_CASES)
def test_intersect_unaligned_matches_plain_on_card(cuda, kind, shape):
    a, b, sent = intersect_inputs(kind, *shape)
    a = _at_offset(torch.as_tensor(a, device=cuda), 1)
    b = _at_offset(torch.as_tensor(b, device=cuda), 1)
    mask, count = intersect_ops.intersect(a, b, sent)
    torch.cuda.synchronize()
    want_mask, want_count = intersect_ref(a, b, sent)
    assert torch.equal(mask, want_mask) and torch.equal(count, want_count)


@pytest.mark.gpu
def test_intersect_writes_every_count_on_card(cuda):
    """``count`` comes from ``torch.empty``, so the kernel must write every
    row, 0 where it has no hit: into outputs filled with garbage, and
    through the wrapper into the very block that a dirty ``count`` of the
    same shape has just handed back to the caching allocator."""
    a, b, sent = intersect_inputs("padded", 300, 16)   # most rows: no hit
    a = torch.as_tensor(a, device=cuda)
    b = torch.as_tensor(b, device=cuda)
    want_mask, want_count = intersect_ref(a, b, sent)
    assert int((want_count == 0).sum()) > 200
    mask = torch.ones(a.shape, dtype=torch.bool, device=cuda)
    count = torch.full((a.shape[0],), -1, dtype=torch.int32, device=cuda)
    intersect_cuda(a, b, sent, mask, count)
    torch.cuda.synchronize()
    assert torch.equal(mask, want_mask) and torch.equal(count, want_count)
    for _ in range(3):
        mask.fill_(True)
        count.fill_(-1)
        dirty = count.data_ptr()
        del mask, count
        mask, count = intersect_ops.intersect(a, b, sent)
        torch.cuda.synchronize()
        assert count.data_ptr() == dirty
        assert torch.equal(mask, want_mask) and torch.equal(count, want_count)


@pytest.mark.gpu
@pytest.mark.parametrize("B,M", DELTA_VLEN_SWEEP + [(5, 4099)])
def test_delta_vlen_kernel_matches_plain_on_card(cuda, B, M):
    ids, n = delta_vlen_inputs(B, M)
    ids = torch.as_tensor(ids, device=cuda)
    before = varint_ops.launches
    delta, vlen = _counted("delta_vlen", varint_ops.delta_vlen, ids, n)
    assert varint_ops.launches == before + 1
    want_delta, want_vlen = delta_vlen_ref(ids, n)
    assert torch.equal(delta, want_delta) and torch.equal(vlen, want_vlen)


def _counted(variant, fn, *args, **kw):
    """``fn(*args)`` on the card, checking that it launched ``variant``
    once and nothing else."""
    before = dict(varint_ops.launches_by_variant)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    want = dict(before, **{variant: before[variant] + 1})
    assert varint_ops.launches_by_variant == want
    return out


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CODEC_ID_CASES))
def test_encode_ids_kernel_matches_plain_on_card(cuda, case):
    ids, n, cap = CODEC_ID_CASES[case](np.random.default_rng(0))
    ids = torch.as_tensor(ids.reshape(-1, ids.shape[-1]), device=cuda)
    got = _counted("encode_ids", varint_ops.encode_ids, ids, n, cap)
    _same(got, varint_ref.encode_ids_ref(ids, n, cap))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CODEC_ROW_CASES))
def test_row_codec_kernels_match_plain_on_card(cuda, case):
    """encode_rows, then decode_rows three ways: compacted, onto the
    slots, and onto the slots of a transposed lane grid written into a
    slice of a larger buffer (the engine's exchange and fetch buffer)."""
    rows, valid, n, dcap, icap = CODEC_ROW_CASES[case](
        np.random.default_rng(2))
    T, S, m, D = rows.shape
    rows = torch.as_tensor(rows.reshape(-1, m, D), device=cuda)
    valid = torch.as_tensor(valid.reshape(-1, m), device=cuda)
    got = _counted("encode_rows", varint_ops.encode_rows, rows, valid, n,
                   dcap, icap)
    want = varint_ref.encode_rows_ref(rows, valid, n, dcap, icap)
    _same(got, want)
    enc = want[:5]
    _same([_counted("decode_rows", varint_ops.decode_rows, *enc, m, D, n)],
          [varint_ref.decode_rows_ref(*enc, m, D, n)])
    on_slots = varint_ref.decode_rows_ref(*enc, m, D, n, valid=valid)
    _same([_counted("decode_rows", varint_ops.decode_rows, *enc, m, D, n,
                    valid=valid)], [on_slots])
    grid = [x.view((T, S) + x.shape[1:]).transpose(0, 1) for x in enc]
    vt = valid.view(T, S, m).transpose(0, 1).contiguous()
    big = torch.full((S, T + 2, m, D), 5, dtype=torch.int32, device=cuda)
    _counted("decode_rows", varint_ops.decode_rows, *grid, m, D, n,
             valid=vt, out=big[:, 1:T + 1])
    assert torch.equal(big[:, 1:T + 1], varint_ref.decode_rows_ref(
        *[x.reshape((-1,) + x.shape[2:]) for x in grid], m, D, n,
        valid=vt.view(-1, m)).view(S, T, m, D))
    assert bool((big[:, 0] == 5).all() and (big[:, T + 1] == 5).all())


@pytest.mark.gpu
@pytest.mark.parametrize("seed", ARBITRARY_STREAM_SEEDS)
def test_decode_rows_kernel_matches_plain_on_arbitrary_streams(cuda, seed):
    """Streams no encoder writes: cut values, degrees past m·D or
    wrapping, lengths out of range, raw lanes cut short."""
    streams, valid, m, D = arbitrary_row_streams(seed)
    enc = [torch.as_tensor(x[0], device=cuda) for x in streams]
    valid = torch.as_tensor(valid[0], device=cuda)
    for v in (None, valid):
        got = _counted("decode_rows", varint_ops.decode_rows, *enc, m, D, 77,
                       valid=v)
        assert torch.equal(got, varint_ref.decode_rows_ref(*enc, m, D, 77,
                                                           valid=v))


def _launch_counts():
    return (ops.launches, intersect_ops.launches,
            *(varint_ops.launches_by_variant[v]
              for v in ("encode_ids", "encode_rows", "decode_rows")))


@pytest.mark.gpu
@pytest.mark.parametrize("q,fmt,wire", [("q1", "dense", "raw"),
                                        ("q2", "dense", "raw"),
                                        ("q6", "dense", "raw"),
                                        ("q1", "bucketed", "varint"),
                                        ("q3", "bucketed", "raw"),
                                        ("q6", "dense", "varint")])
def test_engine_on_card_matches_cpu(cuda, q, fmt, wire):
    pg = partition(erdos_graph(120, 5.0, seed=5), 8, method="bfs")
    pat = Pattern.from_edges(QUERIES[q])
    cfg = EngineConfig(**CAPS, storage_format=fmt, wire_format=wire)
    before = _launch_counts()
    got = rads_enumerate(pg, pat, cfg, device=cuda)
    after = _launch_counts()
    assert after[0] > before[0]
    if fmt == "bucketed":
        assert after[1] > before[1]
    if wire == "varint":
        assert all(a > b for a, b in zip(after[2:], before[2:]))
    want = rads_enumerate(pg, pat, cfg, device="cpu")
    assert got.count == want.count and got.embeddings == want.embeddings
    for k in set(want.stats) - TIMING_KEYS:
        assert got.stats[k] == want.stats[k], k


@pytest.mark.gpu
def test_dist_two_ranks_on_one_card_match_sim(cuda):
    """Two ranks of ``rads_enumerate(mode="dist")`` on ``cuda:0`` under
    gloo, each holding one of two partitions: both equal an in-process
    ``sim`` run on the card (count, embeddings, every non-timing stat),
    and membership launches in both."""
    pg = partition(erdos_graph(120, 5.0, seed=5), 2, method="bfs")
    runs = [("q1", dict(CAPS)),
            ("q2", dict(CAPS, storage_format="bucketed",
                        wire_format="varint"))]
    ranks = run_spawned(pg, runs, device="cuda:0", timeout_s=240.0)
    for (q, kw), *per_rank in zip(runs, *ranks):
        want = rads_enumerate(pg, Pattern.from_edges(QUERIES[q]),
                              EngineConfig(**kw), device=cuda)
        for rank, (count, embs, stats, launches) in enumerate(per_rank):
            assert count == want.count and embs == want.embeddings, (q, rank)
            assert launches > 0, (q, rank)
            assert (stats["process_index"], stats["process_count"]) \
                == (rank, 2)
            for k in set(want.stats) - TIMING_KEYS - {"process_index",
                                                      "process_count"}:
                assert stats[k] == want.stats[k], (q, k)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _assert_close(got, want, tol, per_row=False):
    """Elementwise, as ``tests/test_kernels.py`` checks; ``per_row`` holds
    each output row to ``tol`` times its own largest ``|want|`` instead
    (see ``MOE_ROW_CHECK``)."""
    got, want = got.float(), want.float()
    if per_row:
        err = (got - want).abs().amax(-1)
        bound = tol * want.abs().amax(-1)
        assert bool((err <= bound).all()), float((err / bound).max())
    else:
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def _variant_counted(ops, dtype, bf16_variant, before):
    """One launch, counted under the variant the route must pick: float32
    always takes "simt"."""
    want = bf16_variant if dtype == "bfloat16" else "simt"
    after = ops.launches_by_variant
    assert {k: after[k] - before.get(k, 0) for k in after} == {
        k: int(k == want) for k in after}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,Sq,Skv,H,Hk,D,Dv,causal,q_offset,bf16_variant", [
        *[(2, S, S, H, Hk, D, D, True, 0, "wgmma")
          for S, H, Hk, D in FLASH_SWEEP],
        (2, 100, 100, 4, 4, 64, 64, True, 0, "wgmma"),  # qwen1.5's D
        (1, 37, 150, 4, 1, 128, 128, False, 0, "wgmma"),  # ragged keys
        (2, 40, 170, 4, 2, 16, 16, True, 130, "wgmma"),  # last 40 of 170
        (1, 1024, 1024, 16, 16, 128, 128, True, 0, "wgmma"),  # OLMoE
        (1, 512, 512, 32, 8, 128, 128, True, 0, "wgmma"),  # qwen3-4b 32/8
        # the wgmma variant's tile edges: 128-query and 128-key tiles, the
        # 2-stage ring wrapping, q_offset across a tile, padded heads
        (1, 129, 129, 2, 1, 128, 128, True, 0, "wgmma"),
        (2, 257, 385, 2, 2, 64, 64, False, 0, "wgmma"),
        (1, 200, 455, 4, 2, 128, 128, True, 255, "wgmma"),
        (1, 130, 130, 2, 2, 48, 48, True, 0, "wgmma"),  # one padded panel
        (1, 130, 260, 2, 1, 80, 80, False, 0, "wgmma"),  # second padded
        (1, 64, 64, 2, 2, 72, 72, True, 0, "simt"),      # D % 16 != 0
        # D != Dv: MLA's (192, 128), causal and not, ragged, GQA, q_offset
        (1, 1024, 1024, 16, 16, 192, 128, True, 0, "wgmma"),
        (2, 300, 300, 8, 8, 192, 128, True, 0, "wgmma"),
        (1, 200, 333, 8, 2, 192, 128, False, 0, "wgmma"),
        (1, 130, 390, 4, 1, 192, 128, True, 260, "wgmma"),
        (1, 150, 150, 2, 2, 176, 112, True, 0, "wgmma"),  # padded panels
        # a q/k or a v panel wholly past the head in (128, 128)
        (1, 257, 257, 4, 4, 64, 128, True, 0, "wgmma"),
        (1, 257, 257, 4, 2, 128, 64, False, 0, "wgmma"),
        (2, 100, 100, 4, 2, 24, 16, True, 0, "simt"),   # the reduced MLA
    ])
def test_flash_kernel_matches_plain_on_card(cuda, B, Sq, Skv, H, Hk, D, Dv,
                                            causal, q_offset, bf16_variant,
                                            dtype):
    q, k, v = (torch.as_tensor(a, device=cuda).to(DTYPES[dtype])
               for a in flash_inputs(B, Sq, Skv, H, Hk, D, seed=Sq + H,
                                     Dv=Dv))
    assert flash_ops.route(q.dtype, D, (), Dv) == (
        bf16_variant if dtype == "bfloat16" else "simt")
    before = flash_ops.launches
    by_variant = dict(flash_ops.launches_by_variant)
    got = flash_ops.flash_attention_k(q, k, v, causal=causal,
                                      q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1 and got.shape == (B, Sq, H, Dv)
    _variant_counted(flash_ops, dtype, bf16_variant, by_variant)
    want = flash_ops.flash_attention_plain(q, k, v, causal=causal,
                                           q_offset=q_offset)
    _assert_close(got, want, FLASH_TOL[dtype])
    again = flash_ops.flash_attention_k(q, k, v, causal=causal,
                                        q_offset=q_offset)
    assert torch.equal(again, got)          # deterministic


MOE_CARD_CASES = [
    *[(*shape, "wgmma") for shape in MOE_SWEEP],
    (5, 37, 48, 40, "wgmma"),     # ragged tiles
    (3, 5, 48, 40, "stream"),     # the decode shapes (C <= 8), ragged
    (64, 1, 2048, 1024, "stream"),   # OLMoE decode
    (8, 320, 2048, 1024, "wgmma"),   # OLMoE's widths, prefill tiles
    # the variants' edges: 128-row C tiles, 64-deep K stages and
    # 128/256-wide N tiles with ragged ends; unaligned widths (scalar
    # loads in stream, simt past it)
    (2, 130, 72, 136, "wgmma"),
    (3, 129, 264, 520, "wgmma"),
    (2, 3, 36, 37, "stream"),
    (2, 20, 36, 40, "simt")]
# C = 8 and 9 at OLMoE's widths: the last stream and the first wgmma
# shape.  bf16 only: in f32 at C <= 9 the plain version's cuBLAS product
# sums in another order than at large C, and the simt kernel is held
# elementwise at 1e-5 only where the two orders agree (MOE_ROW_CHECK)
MOE_CARD_BF16_EDGES = [(2, 8, 2048, 1024, "stream"),
                       (2, 9, 2048, 1024, "wgmma")]


@pytest.mark.gpu
@pytest.mark.parametrize("E,C,d,f,bf16_variant,dtype", [
    *[(*case, dtype) for case in MOE_CARD_CASES
      for dtype in ("float32", "bfloat16")],
    *[(*case, "bfloat16") for case in MOE_CARD_BF16_EDGES]])
def test_moe_gemm_kernel_matches_plain_on_card(cuda, E, C, d, f, bf16_variant,
                                               dtype):
    x, wg, wu, wd = (torch.as_tensor(a, device=cuda).to(DTYPES[dtype])
                     for a in moe_inputs(E, C, d, f, seed=E * C))
    before = moe_ops.launches
    by_variant = dict(moe_ops.launches_by_variant)
    got = moe_ops.moe_gemm(x, wg, wu, wd)
    torch.cuda.synchronize()
    assert moe_ops.launches == before + 1
    _variant_counted(moe_ops, dtype, bf16_variant, by_variant)
    if dtype == "float32":
        _assert_close(got, moe_gemm_ref(x, wg, wu, wd), MOE_TOL[dtype],
                      per_row=(dtype, C) == MOE_ROW_CHECK)
        return
    # bf16: each pass against its plain version, elementwise; h and the
    # output against the function computed exactly (h within one bf16
    # rounding, the output within the bound of every rounding); end to end
    # as in float32, except at OLMoE's expert widths through the wgmma
    # variant.  There the tensor cores sum in another order than the plain
    # version, so a few elements of h sit one bf16 step apart, and wd
    # carries such a step past the 5e-2 floor at outputs near 0, as it
    # carries the plain version's own rounding of h past it against the
    # exact function
    h = torch.empty((E, C, f), dtype=x.dtype, device=cuda)
    again = torch.empty_like(x)
    moe_kernel.moe_gemm_cuda(x, wg, wu, wd, h, again, bf16_variant)
    torch.cuda.synchronize()
    assert torch.equal(again, got)         # deterministic
    _assert_close(h, moe_hidden_ref(x, wg, wu), MOE_TOL[dtype])
    _assert_close(got, moe_down_ref(h, wd), MOE_TOL[dtype])
    exact = moe_gemm_f64(x, wg, wu, wd)
    assert bound_ratio(h, exact["h"], exact["h_bound"]) <= 1
    assert bound_ratio(got, exact["out"], exact["out_bound"]) <= 1
    if not (bf16_variant == "wgmma" and (d, f) == (2048, 1024)):
        _assert_close(got, moe_gemm_ref(x, wg, wu, wd), MOE_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("C,variant", [(1, "stream"), (24, "wgmma")])
def test_moe_gemm_kernel_at_deepseek_widths_on_card(cuda, C, variant):
    """DeepSeek-V3's routed experts in bf16: E = 256, d = 7,168, f = 2,048
    (22.5 GB of weights, drawn on the card at the model's init scale
    1/sqrt(E)), at decode (C = 1) and a prefill tile (C = 24).  Each pass
    against its plain version elementwise and against the function
    computed exactly, 16 experts at a time (the plain versions' float32
    and float64 copies of all 256 would take 45 and 90 GB); two launches
    bit-identical."""
    E, d, f = 256, 7168, 2048
    gen = torch.Generator(device=cuda)
    gen.manual_seed(C)
    x = torch.randn((E, C, d), generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    wg, wu = (torch.randn((E, d, f), generator=gen, device=cuda,
                          dtype=torch.bfloat16).mul_(E ** -0.5)
              for _ in range(2))
    wd = torch.randn((E, f, d), generator=gen, device=cuda,
                     dtype=torch.bfloat16).mul_(E ** -0.5)
    assert moe_ops.route(x.dtype, C, d, f) == variant
    by_variant = dict(moe_ops.launches_by_variant)
    got = moe_ops.moe_gemm(x, wg, wu, wd)
    _variant_counted(moe_ops, "bfloat16", variant, by_variant)
    h = torch.empty((E, C, f), dtype=x.dtype, device=cuda)
    again = torch.empty_like(x)
    moe_kernel.moe_gemm_cuda(x, wg, wu, wd, h, again, variant)
    torch.cuda.synchronize()
    assert torch.equal(again, got)
    for e in range(0, E, 16):
        sl = slice(e, e + 16)
        _assert_close(h[sl], moe_hidden_ref(x[sl], wg[sl], wu[sl]),
                      MOE_TOL["bfloat16"])
        _assert_close(got[sl], moe_down_ref(h[sl], wd[sl]),
                      MOE_TOL["bfloat16"])
        exact = moe_gemm_f64(x[sl], wg[sl], wu[sl], wd[sl])
        assert bound_ratio(h[sl], exact["h"], exact["h_bound"]) <= 1
        assert bound_ratio(got[sl], exact["out"], exact["out_bound"]) <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-4b",
                                  "deepseek-v3-671b"])
def test_serving_on_card_matches_cpu(cuda, arch):
    """Reduced model in float32: prefill and four decode steps on the card
    (through both kernels) against the port's CPU run of the same
    weights; DeepSeek-V3's decode steps alternate naive and absorbed."""
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    model = init_lm_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    card = init_lm_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu").to(cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 24),
                           generator=torch.Generator().manual_seed(1))
    before = (flash_ops.launches, moe_ops.launches)
    got, gcache = prefill(card, tokens.to(cuda), max_len=32)
    want, cache = prefill(model, tokens, max_len=32)
    assert flash_ops.launches == before[0] + cfg.n_layers
    if cfg.moe is not None:     # one launch a MoE layer
        assert moe_ops.launches == (before[1] + cfg.n_layers
                                    - cfg.moe.first_k_dense)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    nxt = want[:, -1].argmax(-1)
    for i in range(4):
        absorbed = i % 2 == 1
        got, gcache = decode_step(card, gcache, nxt.to(cuda), 24 + i,
                                  absorbed=absorbed)
        want, cache = decode_step(model, cache, nxt, 24 + i,
                                  absorbed=absorbed)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        nxt = want.argmax(-1)
    assert set(gcache) == set(cache)
    for k in cache:
        torch.testing.assert_close(gcache[k].cpu(), cache[k], rtol=1e-4,
                                   atol=1e-4)


# a backward kernel's gradient against its plain version's: max |diff|
# over max |plain| (chip_smoke.py's TRAIN_TOL)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _bwd_held(got, want, tol):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max()
        assert err <= tol * w.float().abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hk,D,causal,q_offset", [
    (2, 64, 64, 4, 2, 32, True, 0),       # the sweep, GQA 4/2
    (2, 128, 128, 2, 2, 16, True, 0),
    (1, 100, 150, 4, 1, 64, False, 0),    # ragged, non-causal, GQA 4/1
    (1, 333, 333, 8, 2, 128, True, 0),    # ragged causal tiles
    (1, 300, 500, 4, 4, 128, True, 200),  # q_offset past a tile
    (2, 100, 100, 6, 3, 40, True, 0),     # D % 16 != 0: "simt" in bf16
    (1, 129, 129, 4, 2, 64, True, 0),     # one row past a 128-row CTA
    (1, 255, 257, 32, 8, 80, True, 2),    # GQA 32/8, D = 80: two panels
    (2, 257, 255, 4, 4, 16, False, 0),    # D = 16: one padded panel
    (1, 200, 400, 4, 2, 64, True, 130),   # q_offset past a key tile
])
def test_flash_bwd_kernels_match_plain_on_card(cuda, B, Sq, Skv, H, Hk, D,
                                               causal, q_offset, dtype):
    """The forward's lse against the plain forward's, then the three
    backward kernels (one launch each; dkdv and dq through "wgmma" in
    bf16 with D % 16 == 0, else "simt") against the plain backward on the same
    inputs, and bit for bit against a second call."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in
               flash_inputs(B, Sq, Skv, H, Hk, D, seed=Sq))
    do = torch.randn((B, Sq, H, D), generator=torch.Generator().manual_seed(
        Skv)).to(cuda, dt)
    o, lse = flash_ops.flash_attention_k(q, k, v, causal=causal,
                                         q_offset=q_offset, return_lse=True)
    _, lse_plain = flash_ops.flash_attention_plain(q, k, v, causal, q_offset,
                                                   return_lse=True)
    assert (lse - lse_plain).abs().max() <= 1e-4 * lse_plain.abs().max()
    variant = "wgmma" if dtype == "bfloat16" and D % 16 == 0 else "simt"
    before = dict(flash_ops.bwd_launches)
    before_v = dict(flash_ops.bwd_launches_by_variant)
    got = flash_ops.flash_attention_bwd_k(q, k, v, o, lse, do, causal,
                                          q_offset)
    again = flash_ops.flash_attention_bwd_k(q, k, v, o, lse, do, causal,
                                            q_offset)
    torch.cuda.synchronize()
    assert all(flash_ops.bwd_launches[n] == before[n] + 2
               for n in flash_ops.BWD_KERNELS)
    assert (flash_ops.bwd_launches_by_variant[variant]
            == before_v[variant] + 4)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _bwd_held(got, flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                           q_offset), BWD_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f", MOE_SWEEP + [(5, 37, 48, 40),
                                                 (3, 130, 72, 136),
                                                 (3, 37, 36, 20),
                                                 (1, 129, 64, 72),
                                                 (2, 257, 200, 136)])
def test_moe_gemm_bwd_kernel_matches_plain_on_card(cuda, E, C, d, f, dtype):
    """moe_gemm's gradient through the backward kernel (one launch; bf16
    with d and f multiples of 8 through "wgmma", the rest through "simt")
    and the four ``bmm`` against the plain backward, bit for bit twice."""
    dt = getattr(torch, dtype)
    x, wg, wu, wd = (torch.from_numpy(a).to(cuda, dt)
                     for a in moe_inputs(E, C, d, f, seed=C))
    dy = torch.randn((E, C, d), generator=torch.Generator().manual_seed(
        f)).to(cuda, dt)
    variant = ("wgmma" if dtype == "bfloat16" and d % 8 == 0 and f % 8 == 0
               else "simt")
    before = dict(moe_ops.bwd_launches_by_variant)
    got = moe_ops.moe_gemm_bwd_k(x, wg, wu, wd, dy)
    again = moe_ops.moe_gemm_bwd_k(x, wg, wu, wd, dy)
    torch.cuda.synchronize()
    assert moe_ops.bwd_launches_by_variant[variant] == before[variant] + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _bwd_held(got, moe_gemm_bwd_ref(x, wg, wu, wd, dy), BWD_TOL[dtype])


@pytest.mark.gpu
def test_training_step_on_card_matches_cpu(cuda):
    """Reduced OLMoE in float32: ``lm_loss`` and every parameter's
    gradient on the card (forward and backward kernels) against the
    port's CPU run of the same weights."""
    cfg = dataclasses.replace(get_reduced("olmoe-1b-7b"), dtype="float32")
    model = init_lm_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu").requires_grad_(True)
    card = init_lm_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu").to(cuda).requires_grad_(True)
    gen = torch.Generator().manual_seed(1)
    tokens, labels = (torch.randint(0, cfg.vocab, (2, 40), generator=gen)
                      for _ in range(2))
    before = dict(flash_ops.bwd_launches), moe_ops.bwd_launches
    got = lm_loss(card, tokens.to(cuda), labels.to(cuda))
    got.backward()
    want = lm_loss(model, tokens, labels)
    want.backward()
    assert all(flash_ops.bwd_launches[n] == before[0][n] + cfg.n_layers
               for n in flash_ops.BWD_KERNELS)
    assert moe_ops.bwd_launches == before[1] + cfg.n_layers
    torch.testing.assert_close(got.detach().cpu(), want.detach(), rtol=1e-5,
                               atol=1e-5)
    for (name, p), q in zip(model.named_parameters(), card.parameters()):
        err = (q.grad.cpu() - p.grad).abs().max()
        assert err <= 1e-4 * p.grad.abs().max(), name


def _f64_segment_sum(msgs, dst, n):
    """The plain version's function (``segment_spmm_plain``) in float64:
    the reference for the kernel's float32 sums.  ``segment_spmm_plain``
    itself adds in float32 with ``index_add_``'s atomics, in an order
    that changes from run to run: on a row of a thousand edges its own
    error can pass 1e-5, so it cannot be the yardstick of the kernel's
    (fixed-order) float32 sums."""
    out = torch.zeros((n, msgs.shape[1]), dtype=torch.float64,
                      device=msgs.device)
    return out.index_add_(0, dst.long(), msgs.double())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,arg", [
    *[("sweep", shape[:3]) for shape in SPMM_SWEEP],
    *[("edge", case) for case in SPMM_EDGE_CASES]])
def test_segment_spmm_kernel_matches_plain_on_card(cuda, kind, arg, dtype):
    """float32 sums of float32 or bfloat16 messages, elementwise at the
    sweep's 1e-5 against the plain version's sums in float64
    (``_f64_segment_sum``); with bfloat16 out, the float32 sum rounded
    once, so the two may differ by one bfloat16 step (2**-7 of the
    value)."""
    if kind == "sweep":
        msgs, dst = spmm_sweep_inputs(*arg)
        n = arg[1]
    else:
        msgs, dst, n = spmm_edge_inputs(arg)
    msgs = torch.as_tensor(msgs, device=cuda).to(DTYPES[dtype])
    dst = torch.as_tensor(dst, device=cuda)
    plan = spmm_ops.segment_plan(dst, n)
    before = spmm_ops.launches
    got = spmm_ops.segment_spmm(msgs, dst, n, plan)
    torch.cuda.synchronize()
    assert spmm_ops.launches == before + 1
    want = _f64_segment_sum(msgs, dst, n)
    torch.testing.assert_close(got.double(), want, rtol=SPMM_TOL,
                               atol=SPMM_TOL)
    assert torch.equal(got, spmm_ops.segment_spmm(msgs, dst, n, plan))
    if dtype == "bfloat16":
        got16 = spmm_ops.segment_spmm(msgs, dst, n, plan,
                                      out_dtype=torch.bfloat16)
        torch.testing.assert_close(got16.double(), want, rtol=2 ** -7,
                                   atol=SPMM_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_spmm_hub_row_on_card(cuda, dtype):
    """The existing checks on a row above the hub threshold, which the
    kernel sums with a block of its own: elementwise at 1e-5 against a
    float64 sum, two launches bit-identical."""
    msgs, dst, n = spmm_edge_inputs("one_node")
    msgs = torch.as_tensor(msgs, device=cuda).to(DTYPES[dtype])
    dst = torch.as_tensor(dst, device=cuda)
    plan = spmm_ops.segment_plan(dst, n)
    assert plan.n_heavy == 1 and int(plan.heavy[0]) == 3
    before = spmm_ops.launches_by_variant["sum"]
    got = spmm_ops.segment_spmm(msgs, dst, n, plan)
    torch.cuda.synchronize()
    assert spmm_ops.launches_by_variant["sum"] == before + 1
    want = _f64_segment_sum(msgs, dst, n)
    torch.testing.assert_close(got.double(), want, rtol=SPMM_TOL,
                               atol=SPMM_TOL)
    assert torch.equal(got, spmm_ops.segment_spmm(msgs, dst, n, plan))


@pytest.mark.gpu
@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,dout", GAT_HEAD_SHAPES)
def test_gat_aggregate_kernel_matches_plain_on_card(cuda, H, dout, dtype,
                                                    acc):
    """The "gat" variant against ``gat_aggregate_plain`` on a graph with
    masked slots, an empty row, an all-masked row and a hub above the
    threshold.  Each element within 1e-5 (f32) or ``GAT_BF16_TOL`` (bf16
    anywhere) of its row's sum of |msg| against a float64 sum of the
    plain version's messages (the kernel sums in another order, so a
    bf16 rounding of a weight may go the other way), plus one bf16 step
    of its value where the output is bf16.  Two launches are
    bit-identical."""
    x = gat_kernel_inputs(H, dout)
    hw, s_src, s_dst = (torch.as_tensor(x[k], device=cuda).to(DTYPES[dtype])
                        for k in ("hw", "s_src", "s_dst"))
    src, dst, mask = (torch.as_tensor(x[k], device=cuda)
                      for k in ("src", "dst", "mask"))
    n, acc_dt = hw.shape[0], DTYPES[acc]
    plan = spmm_ops.segment_plan(dst, n, src=src, mask=mask)
    assert HUB_NODE in plan.heavy.tolist()
    args = (hw, s_src, s_dst, plan, mask, acc_dt)
    before = spmm_ops.launches_by_variant["gat"]
    got = spmm_ops.gat_aggregate(*args)
    again = spmm_ops.gat_aggregate(*args)
    torch.cuda.synchronize()
    assert spmm_ops.launches_by_variant["gat"] == before + 2
    assert got.dtype == acc_dt and got.shape == (n, H, dout)
    assert torch.equal(got, again)
    assert not got[7].any() and not got[ALL_MASKED_NODE].any()
    msg = spmm_ops.gat_messages_plain(*args).reshape(dst.shape[0], -1)
    s = torch.zeros((n, H * dout), dtype=torch.float64, device=cuda)
    a = torch.zeros_like(s)
    s.index_add_(0, dst, msg.double())
    a.index_add_(0, dst, msg.double().abs())
    bound = (SPMM_TOL if dtype == acc == "float32" else GAT_BF16_TOL) * a
    if acc == "bfloat16":
        bound += 2.0 ** -7 * s.abs()
    diff = (got.reshape(n, -1).double() - s).abs()
    assert bool((diff <= bound).all()), float(
        (diff / bound.clamp_min(1e-300)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,dout", GAT_HEAD_SHAPES)
def test_gat_forward_stats_on_card(cuda, H, dout, dtype, acc):
    """"gat" saving its row statistics for the backward
    (``gat_aggregate_with_stats``): the output bit-identical to the
    forward's without them, one launch; ``m`` equal to the plain
    ``gat_row_stats_plain`` (``-inf`` on the empty and all-masked rows)
    and ``den`` within float32 rounding of it (the kernel adds in its own
    order, and a bfloat16 sum may round a step apart), on the graph with a
    hub, masked slots, an empty and an all-masked row."""
    x = gat_kernel_inputs(H, dout)
    hw, s_src, s_dst = (torch.as_tensor(x[k], device=cuda).to(DTYPES[dtype])
                        for k in ("hw", "s_src", "s_dst"))
    src, dst, mask = (torch.as_tensor(x[k], device=cuda)
                      for k in ("src", "dst", "mask"))
    n, acc_dt = hw.shape[0], DTYPES[acc]
    plan = spmm_ops.segment_plan(dst, n, src=src, mask=mask)
    args = (hw, s_src, s_dst, plan, mask, acc_dt)
    before = spmm_ops.launches_by_variant["gat"]
    out, m, den = spmm_ops.gat_aggregate_with_stats(*args)
    torch.cuda.synchronize()
    assert spmm_ops.launches_by_variant["gat"] == before + 1
    assert torch.equal(out, spmm_ops.gat_aggregate(*args))
    want_m, want_den = spmm_ops.gat_row_stats_plain(s_src, s_dst, plan, mask,
                                                    acc_dt)
    assert m.dtype == den.dtype == torch.float32 and m.shape == (n, H)
    assert torch.equal(m, want_m)
    assert bool(torch.isneginf(m[[7, ALL_MASKED_NODE]]).all())
    rtol = 1e-5 if acc == "float32" else 2.0 ** -7
    torch.testing.assert_close(den, want_den, rtol=rtol, atol=0)


GNN_LAUNCHES = {"graphcast": lambda L: {"sum": L, "gat": 0},
                "schnet": lambda L: {"sum": L, "gat": 0},
                "pna": lambda L: {"sum": 1 + 4 * L, "gat": 0},
                "gat": lambda L: {"sum": 0, "gat": L}}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_on_card_matches_cpu(cuda, arch):
    """Reduced model in float32: ``gnn_forward`` on the card (every
    segment sum through the kernel: "gat" a layer for GAT, "sum" for the
    others) against the port's CPU run of the same weights and graph."""
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    params = init_gnn(torch.Generator().manual_seed(0), cfg, D_FEAT, N_OUT,
                      device="cpu")
    card = {k: _to(v, cuda) for k, v in params.items()}
    arrays = graph_arrays(cfg.kind)
    before = dict(spmm_ops.launches_by_variant)
    got = gnn_forward(card, cfg, graph_batch_from_arrays(arrays, cuda))
    torch.cuda.synchronize()
    assert ({k: n - before[k] for k, n in spmm_ops.launches_by_variant.items()}
            == GNN_LAUNCHES[cfg.kind](cfg.n_layers))
    want = gnn_forward(params, cfg, graph_batch_from_arrays(arrays, "cpu"))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # of the largest |plain|
SOURCE_HUB_NODE = 11      # "gat_bwd"'s walk by source gives it a block


def _bwd_close(got, want, tol, name):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max().clamp_min(1e-30)), (
        name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "float32"),
                                    ("bfloat16", "bfloat16")],
                         ids=["f32", "bf16_msgs", "bf16"])
@pytest.mark.parametrize("kind,arg", [
    *[("sweep", shape[:3]) for shape in SPMM_SWEEP],
    *[("edge", case) for case in SPMM_EDGE_CASES]])
def test_segment_spmm_bwd_kernel_matches_plain_on_card(cuda, kind, arg,
                                                       dtypes):
    """"sum_bwd" (messages' dtype, dout's dtype) against
    ``segment_spmm_bwd_plain``: a gather and a cast, so bit for bit, the
    hub row ("one_node") included; two launches bit-identical."""
    msgs_dt, out_dt = (DTYPES[d] for d in dtypes)
    if kind == "sweep":
        msgs, dst = spmm_sweep_inputs(*arg)
        n = arg[1]
    else:
        msgs, dst, n = spmm_edge_inputs(arg)
    dst = torch.as_tensor(dst, device=cuda)
    dout = torch.randn((n, msgs.shape[1]), device=cuda).to(out_dt)
    plan = spmm_ops.segment_plan(dst, n)
    before = spmm_ops.bwd_launches_by_variant["sum_bwd"]
    got = spmm_ops.segment_spmm_bwd(dout, dst, n, plan, msgs_dt)
    again = spmm_ops.segment_spmm_bwd(dout, dst, n, plan, msgs_dt)
    torch.cuda.synchronize()
    assert spmm_ops.bwd_launches_by_variant["sum_bwd"] == before + 2 * int(
        msgs.size > 0)
    assert torch.equal(got, spmm_ops.segment_spmm_bwd_plain(dout, dst,
                                                            msgs_dt))
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("scores", ["random", "zero_at_loops"])
@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,dout", GAT_HEAD_SHAPES)
def test_gat_bwd_kernel_matches_plain_on_card(cuda, H, dout, dtype, acc,
                                              scores):
    """"gat_bwd" against ``gat_aggregate_bwd_plain``, both from the card
    forward's row statistics and output, on the graph with masked slots,
    an empty row, an all-masked row, a hub by destination and one by
    source (a block of the walk by source), also with self-loops whose
    pre-activations are exactly 0 (leaky_relu's slope 1 there): each
    gradient within 1e-4 (f32) or 2e-2 (bf16 anywhere) of its largest
    plain value; the empty and all-masked rows' ds_dst 0; two calls
    bit-identical."""
    x = gat_kernel_inputs(H, dout, zero_scores=scores == "zero_at_loops")
    x["src"][1::20] = SOURCE_HUB_NODE        # 330 slots out of one node
    hw, s_src, s_dst = (torch.as_tensor(x[k], device=cuda).to(DTYPES[dtype])
                        for k in ("hw", "s_src", "s_dst"))
    src, dst, mask = (torch.as_tensor(x[k], device=cuda)
                      for k in ("src", "dst", "mask"))
    n, acc_dt = hw.shape[0], DTYPES[acc]
    plan = spmm_ops.segment_plan(dst, n, src=src, mask=mask)
    by_src = spmm_ops.source_plan(plan)
    assert HUB_NODE in plan.heavy.tolist()
    assert SOURCE_HUB_NODE in by_src.heavy.tolist()
    out, m, den = spmm_ops.gat_aggregate_with_stats(hw, s_src, s_dst, plan,
                                                    mask, acc_dt)
    g = torch.randn(hw.shape, device=cuda).to(acc_dt)
    args = (hw, s_src, s_dst, plan, mask, acc_dt, g, m, den, out)
    before = spmm_ops.bwd_launches_by_variant["gat_bwd"]
    got = spmm_ops.gat_aggregate_bwd(*args, by_src)
    again = spmm_ops.gat_aggregate_bwd(*args, by_src)
    torch.cuda.synchronize()
    assert spmm_ops.bwd_launches_by_variant["gat_bwd"] == before + 2
    want = spmm_ops.gat_aggregate_bwd_plain(*args)
    tol = BWD_TOL["float32" if dtype == acc == "float32" else "bfloat16"]
    for name, a, b, c in zip(("dhw", "ds_src", "ds_dst"), got, want, again):
        _bwd_close(a, b, tol, name)
        assert torch.equal(a, c), name
    assert not got[2][7].any() and not got[2][ALL_MASKED_NODE].any()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_training_step_on_card_matches_cpu(cuda, arch):
    """Reduced model in float32: ``gnn_loss`` and every gradient on the
    card (through "sum_bwd" or "gat_bwd") against the port's CPU run of
    the same weights and graph."""
    from repro_torch.models import GNNModel
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    params = init_gnn(torch.Generator().manual_seed(0), cfg, D_FEAT, N_OUT,
                      device="cpu")
    arrays = graph_arrays(cfg.kind)
    cpu = GNNModel(cfg, params).requires_grad_(True)
    card = GNNModel(cfg, _to(params, cuda)).requires_grad_(True)
    before = dict(spmm_ops.bwd_launches_by_variant)
    loss = card.loss(graph_batch_from_arrays(arrays, cuda))
    loss.backward()
    torch.cuda.synchronize()
    ran = {k: v - before[k]
           for k, v in spmm_ops.bwd_launches_by_variant.items()}
    variant = "gat_bwd" if cfg.kind == "gat" else "sum_bwd"
    assert ran[variant] > 0
    want = cpu.loss(graph_batch_from_arrays(arrays, "cpu"))
    want.backward()
    assert abs(float(loss.detach()) - float(want.detach())) <= 1e-4 * abs(
        float(want.detach()))
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        err = (q.grad.cpu() - p.grad).abs().max()
        assert err <= 1e-4 * p.grad.abs().max().clamp_min(1e-30), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_din_training_step_on_card_matches_cpu(cuda, dtype, tol):
    """Reduced DIN: the loss and every gradient on the card (the bag
    through "sum" and "sum_bwd", each table's gradient through
    ``TableGather``'s "sum") against the port's CPU run of the same
    weights and batch, and the same bits from a second step."""
    from repro_torch.data import din_batch_stream
    from repro_torch.models import DINBatch, DINModel, init_din
    cfg = dataclasses.replace(get_reduced("din"), dtype=dtype)
    params = init_din(torch.Generator().manual_seed(0), cfg, device="cpu")
    arrays = next(din_batch_stream(cfg.n_items, cfg.n_cates,
                                   cfg.n_user_feats, 64, cfg.seq_len))

    def step(model, device):
        model.zero_grad(set_to_none=True)
        loss = model.loss(DINBatch.from_arrays(arrays, device))
        loss.backward()
        return loss.detach(), [p.grad.clone() for p in model.parameters()]

    card = DINModel(cfg, _to(params, cuda)).requires_grad_(True)
    before = {**spmm_ops.launches_by_variant,
              **spmm_ops.bwd_launches_by_variant}
    loss, grads = step(card, cuda)
    torch.cuda.synchronize()
    after = {**spmm_ops.launches_by_variant,
             **spmm_ops.bwd_launches_by_variant}
    assert {k: after[k] - before[k] for k in ("sum", "sum_bwd")} == {
        "sum": 4, "sum_bwd": 1}
    loss2, grads2 = step(card, cuda)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    cpu = DINModel(cfg, params).requires_grad_(True)
    want, want_grads = step(cpu, "cpu")
    assert abs(float(loss) - float(want)) <= tol * abs(float(want))
    for (name, _), g, w in zip(cpu.named_parameters(), grads, want_grads):
        err = (g.cpu().float() - w.float()).abs().max()
        assert err <= tol * w.float().abs().max().clamp_min(1e-30), name


def _eager_runner_cache(pg, pat, cfg, device, mode="sim") -> dict:
    """A ``runner_cache`` holding, under the driver's key for the call, a
    StageRunner built as the driver builds it with ``eager=True``."""
    from repro_torch.core.cache import build_cache
    from repro_torch.core.engine import build_plan_data
    from repro_torch.core.exchange import Exchange
    from repro_torch.core.plan import best_plan
    from repro_torch.core.scheduler import StageRunner
    from repro_torch.graph.storage import device_graph
    exch = Exchange(mode, wire_format=cfg.wire_format)
    g = device_graph(pg, cfg.storage_format, device)
    runner = StageRunner(g, build_plan_data(best_plan(pat, cfg.plan_rho)),
                         cfg, exch, cache=build_cache(cfg, g), eager=True)
    return {(mode, id(pg), pat, cfg, None, str(torch.device(device))):
            (pg, None, runner)}


@pytest.mark.gpu
@pytest.mark.parametrize("mode,fmt,wire", [("sim", "dense", "raw"),
                                           ("sim", "bucketed", "varint"),
                                           ("gather", "dense", "raw")])
@pytest.mark.parametrize("q", ["q1", "q3", "q6"])
def test_stage_graphs_match_eager_on_card(cuda, q, mode, fmt, wire):
    """The stages captured as CUDA graphs give the eager stages' results
    bit for bit; a second call through ``runner_cache`` captures
    nothing and launches what an eager second call launches."""
    pg = partition(erdos_graph(120, 5.0, seed=5), 8, method="bfs")
    pat = Pattern.from_edges(QUERIES[q])
    cfg = EngineConfig(**CAPS, storage_format=fmt, wire_format=wire)
    rc, erc = {}, _eager_runner_cache(pg, pat, cfg, cuda, mode)
    for call in range(2):
        before = _launch_counts()
        got = rads_enumerate(pg, pat, cfg, mode=mode, device=cuda,
                             runner_cache=rc)
        mid = _launch_counts()
        want = rads_enumerate(pg, pat, cfg, mode=mode, device=cuda,
                              runner_cache=erc)
        after = _launch_counts()
        assert len(erc) == 1 and want.stats["compiles"] == 0
        assert (got.stats["compiles"] > 0) == (call == 0)
        assert got.count == want.count and got.embeddings == want.embeddings
        for k in set(want.stats) - TIMING_KEYS:
            assert got.stats[k] == want.stats[k], (call, k)
    assert got.stats["compile_s"] == 0.0
    assert [m - b for m, b in zip(mid, before)] == [
        a - m for a, m in zip(after, mid)]


_STORE_CHILD = """
import json, sys
from pathlib import Path
from repro_torch.configs.rads import QUERIES, EngineConfig
from repro_torch.core import Pattern, rads_enumerate
from repro_torch.graph import erdos_graph, partition
from repro_torch.kernels import build
build.BUILD_DIR = Path(sys.argv[2])
built, real = [], build.build
build.build = lambda sources: built.extend(real(sources)) or {}
pg = partition(erdos_graph(120, 5.0, seed=5), 8, method="bfs")
rc = {}
res = rads_enumerate(pg, Pattern.from_edges(QUERIES["q1"]),
                     EngineConfig(**json.loads(sys.argv[3]),
                                  compile_cache_dir=sys.argv[1]),
                     device="cuda", runner_cache=rc)
print(json.dumps(dict(count=res.count, compiles=res.stats["compiles"],
                      hits=res.stats["compile_cache_hits"],
                      enabled=res.stats["exec_cache_enabled"],
                      stages=len(next(iter(rc.values()))[-1]._slots),
                      built=[str(s) for s in built],
                      libs=sorted(p.name for p in build.BUILD_DIR.iterdir()
                                  if p.suffix == ".so"))))
"""


@pytest.mark.gpu
def test_warm_store_in_fresh_process_captures_nothing(cuda, tmp_path):
    """A store filled here serves a fresh process whose kernel directory
    is empty: no stage counted as a compile, every stage a store hit, the
    libraries written back from the store and no nvcc run."""
    pg = partition(erdos_graph(120, 5.0, seed=5), 8, method="bfs")
    store = str(tmp_path / "store")
    cold = rads_enumerate(pg, Pattern.from_edges(QUERIES["q1"]),
                          EngineConfig(**CAPS, compile_cache_dir=store),
                          device=cuda)
    assert cold.stats["compiles"] > 0 and cold.stats["exec_cache_enabled"]
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run(
        [sys.executable, "-c", _STORE_CHILD, store, str(tmp_path / "kernels"),
         json.dumps(CAPS)], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.abspath(src)))
    assert out.returncode == 0, out.stdout + out.stderr
    warm = json.loads(out.stdout.strip().splitlines()[-1])
    assert warm["count"] == cold.count and warm["enabled"]
    assert warm["compiles"] == 0 and warm["built"] == []
    assert warm["hits"] == warm["stages"] > 0
    assert warm["libs"] and all(n.startswith("libmembership")
                                for n in warm["libs"])


_FAILING_CAPTURE = """
from repro_torch.configs.rads import QUERIES, EngineConfig
from repro_torch.core import Pattern, rads_enumerate
from repro_torch.core.engine import verify_stage
from repro_torch.core.scheduler import StageRunner
from repro_torch.graph import erdos_graph, partition


def make_verify(self, ui, local_only, cfg):
    def verify(gg, s):
        s.alive.sum().item()          # a host sync: no graph can hold it
        return verify_stage(gg, self.pd, cfg, self.exch, ui, s, local_only)
    return verify


StageRunner._make_verify = make_verify
pg = partition(erdos_graph(120, 5.0, seed=5), 8, method="bfs")
try:
    rads_enumerate(pg, Pattern.from_edges(QUERIES["q1"]),
                   EngineConfig(frontier_cap=1 << 12, fetch_cap=256,
                                verify_cap=1024, region_group_budget=1 << 11,
                                prewarm=False), device="cuda")
except RuntimeError as e:
    print("RAISED", e)
else:
    print("NO ERROR")
# the failed capture left no capture open in the allocator: emptying a
# pool (a MemPool's destructor) aborts the process while one is open
import torch
pool = torch.cuda.MemPool()
with torch.cuda.use_mem_pool(pool):
    x = torch.ones(1 << 20, device="cuda")
del x, pool
torch.cuda.synchronize()
print("ALLOCATOR CLEAN")
"""


@pytest.mark.gpu
def test_failed_capture_raises_with_the_stage(cuda):
    """A stage that cannot be captured (here one that syncs with the
    host) raises with its key and capacities; nothing runs it eagerly
    instead.  In a fresh process: a failed capture may leave the
    allocator's capture state behind."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", _FAILING_CAPTURE],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=os.path.abspath(src)))
    assert re.search(r"RAISED capturing stage \('verify', 0, (True|False)\) "
                     r"at capacities \(4096, 256, 1024\) failed",
                     out.stdout), out.stdout + out.stderr
    assert out.returncode == 0 and "ALLOCATOR CLEAN" in out.stdout, (
        out.stdout + out.stderr)


_DROP_DURING_CAPTURE = """
import threading
import torch
from repro_torch.configs.rads import QUERIES, EngineConfig
from repro_torch.core import Pattern, rads_enumerate
from repro_torch.graph import erdos_graph, partition

pg = partition(erdos_graph(120, 5.0, seed=5), 8, method="bfs")
rc = {}
res = rads_enumerate(pg, Pattern.from_edges(QUERIES["q1"]),
                     EngineConfig(frontier_cap=1 << 12, fetch_cap=256,
                                  verify_cap=1024,
                                  region_group_budget=1 << 11),
                     runner_cache=rc, device="cuda")
assert res.stats["compiles"] > 0
opened, dropped = threading.Event(), threading.Event()
x = torch.ones(1024, device="cuda")


def capture():
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        y = x * 2
        opened.set()
        dropped.wait()
        graph.capture_end()
    graph.replay()
    torch.cuda.synchronize()
    assert float(y.sum()) == 2048.0


th = threading.Thread(target=capture)
th.start()
opened.wait()
rc.clear()          # the runner and its graphs go while the capture is open
dropped.set()
th.join()
torch.cuda.empty_cache()
torch.cuda.synchronize()
print("DROPPED", res.count)
"""


@pytest.mark.gpu
def test_runner_dropped_during_another_capture(cuda):
    """A graphed runner (its graphs and their memory pool) may be dropped
    while another thread holds a capture open: nothing it does on the way
    out synchronises, so the process neither aborts nor breaks the other
    capture.  In a fresh process, since an abort would end it."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", _DROP_DURING_CAPTURE],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=os.path.abspath(src)))
    assert out.returncode == 0 and "DROPPED" in out.stdout, (
        out.stdout + out.stderr)
