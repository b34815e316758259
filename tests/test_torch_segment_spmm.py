"""The port's segment_spmm module: the kernel's plain PyTorch version (the
wrapper on a CPU tensor) against the reference's Pallas pipeline in
interpret mode and its dense oracle, at the reference's sweep shapes and
at edge cases, to rtol = atol = 1e-5; the CSR plan (with the GAT
variant's fields and the hub rows) and its reuse; input checks, and the
"gat" variant's shape limits.  The CUDA kernel is held against the plain
version on the card in ``test_torch_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_spmm.kernel import segment_spmm_pallas
from repro.kernels.segment_spmm.ops import (pack_messages, segment_spmm_tiled,
                                            tile_edges)
from repro.kernels.segment_spmm.ref import segment_sum_dense

from _gnn_cases import (GAT_HEAD_SHAPES, SPMM_EDGE_CASES, SPMM_SWEEP,
                        SPMM_TOL, edge_inputs, gat_kernel_inputs,
                        sweep_inputs)
from repro_torch.kernels.segment_spmm import ops
from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref

torch.set_num_threads(1)


def _close(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=SPMM_TOL, atol=SPMM_TOL)


@pytest.mark.parametrize("E,N,D,tn,te", SPMM_SWEEP)
def test_plain_matches_pallas_sweep(E, N, D, tn, te):
    msgs, dst = sweep_inputs(E, N, D)
    tiled = segment_spmm_tiled(jnp.asarray(msgs), dst, N, tn=tn, te=te,
                               use_kernel=True, interpret=True)
    dense = segment_sum_dense(jnp.asarray(msgs), jnp.asarray(dst), N)
    got = ops.segment_spmm(torch.from_numpy(msgs), torch.from_numpy(dst), N)
    assert got.shape == (N, D)
    _close(got, tiled)
    _close(got, dense)


@pytest.mark.parametrize("E,N,D,tn,te", SPMM_SWEEP)
def test_tiled_plain_matches_pallas_kernel(E, N, D, tn, te):
    """``segment_spmm_ref`` over the reference's tiled layout, drop slot
    included, against the Pallas kernel on the same tiles."""
    msgs, dst = sweep_inputs(E, N, D)
    buf, dl, _, _ = pack_messages(jnp.asarray(msgs), jnp.asarray(dst),
                                  tile_edges(dst, N, tn, te), tn, te)
    want = segment_spmm_pallas(buf, dl, tn, interpret=True)
    got = segment_spmm_ref(torch.from_numpy(np.array(buf)),
                           torch.from_numpy(np.array(dl)), tn)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SPMM_EDGE_CASES)
def test_plain_edge_cases(case, dtype):
    """bfloat16 messages are summed in float32: the reference's dense
    oracle casts them first too."""
    msgs, dst, n = edge_inputs(case)
    jmsgs = jnp.asarray(msgs, getattr(jnp, dtype))
    want = segment_sum_dense(jmsgs, jnp.asarray(dst), n)
    tmsgs = torch.from_numpy(msgs).to(getattr(torch, dtype))
    got = ops.segment_spmm(tmsgs, torch.from_numpy(dst), n)
    assert got.shape == (n, msgs.shape[1])
    _close(got, want)
    if case == "empty_rows":
        assert not got[1::2].any()


def test_plan_is_the_sorted_csr_and_is_reused():
    msgs, dst = sweep_inputs(300, 50, 8)
    tdst = torch.from_numpy(dst)
    plan = ops.segment_plan(tdst, 50)
    np.testing.assert_array_equal(plan.perm.numpy(),
                                  np.argsort(dst, kind="stable"))
    np.testing.assert_array_equal(
        plan.rowptr.numpy(), np.concatenate([[0], np.cumsum(
            np.bincount(dst, minlength=50))]))
    assert plan.perm.dtype == plan.rowptr.dtype == torch.int32
    assert (plan.n, plan.n_edges) == (50, 300)
    tm = torch.from_numpy(msgs)
    first = ops.segment_spmm(tm, tdst, 50, plan)
    again = ops.segment_spmm(2 * tm, tdst, 50, plan)
    torch.testing.assert_close(again, 2 * first, rtol=0, atol=0)
    with pytest.raises(ValueError):
        ops.segment_spmm(tm, tdst, 51, plan)          # plan of another n
    with pytest.raises(ValueError):
        ops.segment_spmm(tm[:10], tdst[:10], 50, plan)  # another E


def test_out_dtype_and_trailing_axes():
    """(E, H, d) messages sum to (n, H, d); bfloat16 out is the float32
    sum rounded once."""
    msgs, dst = sweep_inputs(300, 50, 8)
    tm = torch.from_numpy(msgs).bfloat16().reshape(300, 2, 4)
    tdst = torch.from_numpy(dst)
    f32 = ops.segment_spmm(tm, tdst, 50)
    b16 = ops.segment_spmm(tm, tdst, 50, out_dtype=torch.bfloat16)
    assert f32.shape == b16.shape == (50, 2, 4)
    assert f32.dtype == torch.float32 and b16.dtype == torch.bfloat16
    assert torch.equal(b16, f32.bfloat16())


def test_plan_and_wrapper_reject_bad_inputs():
    m = torch.zeros((4, 3))
    d = torch.tensor([0, 1, 2, 1], dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.segment_plan(d, 2)                        # id 2 >= n
    with pytest.raises(RuntimeError):
        ops.segment_plan(-d, 3)                       # negative ids
    with pytest.raises(ValueError):
        ops.segment_plan(d.float(), 3)
    with pytest.raises(TypeError):
        ops.segment_spmm(m.double(), d, 3)
    with pytest.raises(TypeError):
        ops.segment_spmm(m, d, 3, out_dtype=torch.bfloat16)  # f32 -> bf16
    with pytest.raises(TypeError):
        ops.segment_spmm(m, d.float(), 3)
    with pytest.raises(ValueError):
        ops.segment_spmm(m[:3], d, 3)                 # E mismatch


def test_cpu_path_launches_nothing():
    before = ops.launches
    msgs, dst = sweep_inputs(64, 7, 4)
    ops.segment_spmm(torch.from_numpy(msgs), torch.from_numpy(dst), 7)
    assert ops.launches == before


@pytest.mark.parametrize("hub", [0, 100, 200])
def test_plan_gat_fields_and_hub_rows(hub):
    """``src_sorted``, ``live_sorted``, the row order with each row's
    edge span, and the hub rows against a numpy construction, on graphs
    whose hub node has ``hub`` slots more than the others (above
    ``HUB_DEGREE`` at 200 only)."""
    x = gat_kernel_inputs(2, 4, N=60, E=600, hub=hub)
    src, dst, mask = (torch.from_numpy(x[k]) for k in ("src", "dst", "mask"))
    plan = ops.segment_plan(dst, 60, src=src, mask=mask)
    perm = np.argsort(x["dst"], kind="stable")
    counts = np.bincount(x["dst"], minlength=60)
    np.testing.assert_array_equal(plan.perm.numpy(), perm)
    np.testing.assert_array_equal(plan.src_sorted.numpy(), x["src"][perm])
    np.testing.assert_array_equal(plan.live_sorted.numpy(), x["mask"][perm])
    order = np.argsort(-counts, kind="stable")
    rowptr = np.concatenate([[0], np.cumsum(counts)])
    np.testing.assert_array_equal(plan.spans.numpy(), np.stack(
        [order, rowptr[order], rowptr[order + 1], 0 * order], 1))
    np.testing.assert_array_equal(plan.order.numpy(), order)
    heavy = np.flatnonzero(counts > ops.HUB_DEGREE)
    assert plan.n_heavy == len(heavy) == (hub == 200)
    np.testing.assert_array_equal(np.sort(plan.heavy.numpy()), heavy)
    assert plan.src_sorted.dtype == plan.spans.dtype == torch.int32
    assert plan.live_sorted.dtype == torch.bool
    assert plan.src is src and plan.dst is dst and plan.mask is mask
    bare = ops.segment_plan(dst, 60)
    assert bare.src_sorted is None and bare.live_sorted is None
    assert bare.n_heavy == int((counts > ops.HUB_DEGREE).sum())


def test_gat_aggregate_rejects_bad_inputs():
    x = gat_kernel_inputs(2, 4, N=20, E=100, hub=0)
    hw, s_src, s_dst = (torch.from_numpy(x[k])
                        for k in ("hw", "s_src", "s_dst"))
    dst, src, mask = (torch.from_numpy(x[k]) for k in ("dst", "src", "mask"))
    plan = ops.segment_plan(dst, 20, src=src, mask=mask)
    f32 = torch.float32
    assert ops.gat_aggregate(hw, s_src, s_dst, plan, mask, f32).shape == (
        20, 2, 4)
    with pytest.raises(ValueError):               # a plan without sources
        ops.gat_aggregate(hw, s_src, s_dst, ops.segment_plan(dst, 20), mask,
                          f32)
    with pytest.raises(ValueError):               # s_src of other heads
        ops.gat_aggregate(hw, s_src[:, :1], s_dst, plan, mask, f32)
    with pytest.raises(ValueError):               # a mask of other edges
        ops.gat_aggregate(hw, s_src, s_dst, plan, mask[1:], f32)
    with pytest.raises(TypeError):                # mixed dtypes
        ops.gat_aggregate(hw, s_src.bfloat16(), s_dst, plan, mask, f32)
    with pytest.raises(TypeError):
        ops.gat_aggregate(hw, s_src, s_dst, plan, mask, torch.float64)
    with pytest.raises(ValueError):               # ids like dst, not float
        ops.segment_plan(dst, 20, src=src.float())


def test_gat_shape_limits():
    """The kernel's limits: at most 32 vectors a row, each over at most 2
    heads.  GAT's reduced and full head shapes fit in both dtypes."""
    for dt in (torch.float32, torch.bfloat16):
        for H, dout in GAT_HEAD_SHAPES + [(2, 7), (8, 16)]:
            assert ops.gat_shape_fits(H, dout, dt), (H, dout, dt)
        assert not ops.gat_shape_fits(8, 33 if dt == torch.float32 else 65,
                                      dt)                    # > 32 vectors
    assert not ops.gat_shape_fits(8, 5, torch.bfloat16)      # 3 heads
    assert not ops.gat_shape_fits(3, 11, torch.float32)      # 33 values
    assert ops.gat_shape_fits(8, 5, torch.float32)


def test_gat_cpu_path_launches_nothing():
    before = dict(ops.launches_by_variant), ops.launches
    x = gat_kernel_inputs(2, 4, N=20, E=100, hub=0)
    dst, src, mask = (torch.from_numpy(x[k]) for k in ("dst", "src", "mask"))
    ops.gat_aggregate(*(torch.from_numpy(x[k])
                        for k in ("hw", "s_src", "s_dst")),
                      ops.segment_plan(dst, 20, src=src, mask=mask), mask,
                      torch.float32)
    assert (dict(ops.launches_by_variant), ops.launches) == before
