"""Card-only tests of the PyTorch port: the hand-written CUDA kernels
(membership, intersect, delta_vlen, flash_attn, moe_gemm, segment_spmm)
against their plain PyTorch versions, the whole engine on the card —
dense and bucketed storage, raw and varint wire — the reduced OLMoE
serving path and the four reduced GNNs, against the port's CPU path.
They skip without a CUDA card, and import no JAX, so they run where
only PyTorch is installed:
``PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py``."""
import dataclasses

import pytest
import torch

from _gnn_cases import (D_FEAT, GNN_ARCHS, N_OUT, SPMM_EDGE_CASES,
                        SPMM_SWEEP, SPMM_TOL, graph_arrays)
from _gnn_cases import edge_inputs as spmm_edge_inputs
from _gnn_cases import sweep_inputs as spmm_sweep_inputs
from _codec_cases import (DELTA_VLEN_SWEEP, INTERSECT_CASES,
                          delta_vlen_inputs, intersect_inputs)
from _lm_cases import (FLASH_SWEEP, FLASH_TOL, MOE_ROW_CHECK, MOE_SWEEP,
                       MOE_TOL, flash_inputs, moe_inputs)
from _membership_cases import CASES, edge_inputs, sweep_inputs
from repro_torch.configs import get_reduced
from repro_torch.configs.rads import QUERIES, EngineConfig
from repro_torch.convert import graph_batch_from_arrays
from repro_torch.core import Pattern, rads_enumerate
from repro_torch.graph import erdos_graph, partition
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.intersect import ops as intersect_ops
from repro_torch.kernels.intersect.ref import intersect_ref
from repro_torch.kernels.membership import ops
from repro_torch.kernels.membership.ref import membership_ref
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.kernels.varint import ops as varint_ops
from repro_torch.kernels.varint.ref import delta_vlen_ref
from repro_torch.models import (decode_step, gnn_forward, init_gnn,
                                init_lm_params, prefill)

CAPS = dict(frontier_cap=1 << 12, fetch_cap=256, verify_cap=1024,
            region_group_budget=1 << 11)
TIMING_KEYS = {"wave_s_total", "sme_wall_us", "dist_wall_us", "wall_us",
               "sme_pipeline_s", "dist_pipeline_s"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind,arg", CASES)
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
@pytest.mark.parametrize("kind,shape", INTERSECT_CASES)
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
@pytest.mark.parametrize("B,M", DELTA_VLEN_SWEEP + [(5, 4099)])
def test_delta_vlen_kernel_matches_plain_on_card(cuda, B, M):
    ids, n = delta_vlen_inputs(B, M)
    ids = torch.as_tensor(ids, device=cuda)
    before = varint_ops.launches
    delta, vlen = varint_ops.delta_vlen(ids, n)
    torch.cuda.synchronize()
    assert varint_ops.launches == before + 1
    want_delta, want_vlen = delta_vlen_ref(ids, n)
    assert torch.equal(delta, want_delta) and torch.equal(vlen, want_vlen)


def _launch_counts():
    return (ops.launches, intersect_ops.launches, varint_ops.launches)


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
        assert after[2] > before[2]
    want = rads_enumerate(pg, pat, cfg, device="cpu")
    assert got.count == want.count and got.embeddings == want.embeddings
    for k in set(want.stats) - TIMING_KEYS:
        assert got.stats[k] == want.stats[k], k


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hk,D,causal,q_offset", [
    *[(2, S, S, H, Hk, D, True, 0) for S, H, Hk, D in FLASH_SWEEP],
    (2, 100, 100, 4, 4, 64, True, 0),      # ragged tiles, qwen1.5's D
    (1, 37, 150, 4, 1, 128, False, 0),     # non-causal, ragged keys
    (2, 40, 170, 4, 2, 16, True, 130),     # the last 40 of 170
    (1, 1024, 1024, 16, 16, 128, True, 0),  # OLMoE's heads
    (1, 512, 512, 32, 8, 128, True, 0),     # qwen3-4b's GQA 32/8
])
def test_flash_kernel_matches_plain_on_card(cuda, B, Sq, Skv, H, Hk, D,
                                            causal, q_offset, dtype):
    q, k, v = (torch.as_tensor(a, device=cuda).to(DTYPES[dtype])
               for a in flash_inputs(B, Sq, Skv, H, Hk, D, seed=Sq + H))
    before = flash_ops.launches
    got = flash_ops.flash_attention_k(q, k, v, causal=causal,
                                      q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    want = flash_ops.flash_attention_plain(q, k, v, causal=causal,
                                           q_offset=q_offset)
    _assert_close(got, want, FLASH_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f", [
    *MOE_SWEEP,
    (5, 37, 48, 40),       # ragged tiles
    (3, 5, 48, 40),        # the decode tiles (C <= 8), ragged
    (64, 1, 2048, 1024),   # OLMoE decode
    (8, 320, 2048, 1024)])  # OLMoE's widths, prefill tiles
def test_moe_gemm_kernel_matches_plain_on_card(cuda, E, C, d, f, dtype):
    x, wg, wu, wd = (torch.as_tensor(a, device=cuda).to(DTYPES[dtype])
                     for a in moe_inputs(E, C, d, f, seed=E * C))
    before = moe_ops.launches
    got = moe_ops.moe_gemm(x, wg, wu, wd)
    torch.cuda.synchronize()
    assert moe_ops.launches == before + 1
    want = moe_gemm_ref(x, wg, wu, wd)
    _assert_close(got, want, MOE_TOL[dtype],
                  per_row=(dtype, C) == MOE_ROW_CHECK)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-4b"])
def test_serving_on_card_matches_cpu(cuda, arch):
    """Reduced model in float32: prefill and four decode steps on the card
    (through both kernels) against the port's CPU run of the same
    weights."""
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
    if cfg.moe is not None:
        assert moe_ops.launches == before[1] + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    nxt = want[:, -1].argmax(-1)
    for i in range(4):
        got, gcache = decode_step(card, gcache, nxt.to(cuda), 24 + i)
        want, cache = decode_step(model, cache, nxt, 24 + i)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        nxt = want.argmax(-1)
    for k in ("k", "v"):
        torch.testing.assert_close(gcache[k].cpu(), cache[k], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,arg", [
    *[("sweep", shape[:3]) for shape in SPMM_SWEEP],
    *[("edge", case) for case in SPMM_EDGE_CASES]])
def test_segment_spmm_kernel_matches_plain_on_card(cuda, kind, arg, dtype):
    """float32 sums of float32 or bfloat16 messages, elementwise at the
    sweep's 1e-5; with bfloat16 out, the float32 sum rounded once, so
    the two may differ by one bfloat16 step (2**-7 of the value)."""
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
    want = spmm_ops.segment_spmm_plain(msgs, dst, n)
    torch.testing.assert_close(got, want, rtol=SPMM_TOL, atol=SPMM_TOL)
    assert torch.equal(got, spmm_ops.segment_spmm(msgs, dst, n, plan))
    if dtype == "bfloat16":
        got16 = spmm_ops.segment_spmm(msgs, dst, n, plan,
                                      out_dtype=torch.bfloat16)
        torch.testing.assert_close(got16.float(), want, rtol=2 ** -7,
                                   atol=SPMM_TOL)


GNN_LAUNCHES = {"graphcast": lambda L: L, "schnet": lambda L: L,
                "pna": lambda L: 1 + 4 * L, "gat": lambda L: 2 * L}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_on_card_matches_cpu(cuda, arch):
    """Reduced model in float32: ``gnn_forward`` on the card (every
    segment sum through the kernel) against the port's CPU run of the
    same weights and graph."""
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    params = init_gnn(torch.Generator().manual_seed(0), cfg, D_FEAT, N_OUT,
                      device="cpu")
    card = {k: _to(v, cuda) for k, v in params.items()}
    arrays = graph_arrays(cfg.kind)
    before = spmm_ops.launches
    got = gnn_forward(card, cfg, graph_batch_from_arrays(arrays, cuda))
    torch.cuda.synchronize()
    assert (spmm_ops.launches - before
            == GNN_LAUNCHES[cfg.kind](cfg.n_layers))
    want = gnn_forward(params, cfg, graph_batch_from_arrays(arrays, "cpu"))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)
