"""The port's segment_spmm module: the kernel's plain PyTorch version (the
wrapper on a CPU tensor) against the reference's Pallas pipeline in
interpret mode and its dense oracle, at the reference's sweep shapes and
at edge cases, to rtol = atol = 1e-5; the CSR plan and its reuse; input
checks.  The CUDA kernel is held against the plain version on the card
in ``test_torch_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_spmm.kernel import segment_spmm_pallas
from repro.kernels.segment_spmm.ops import (pack_messages, segment_spmm_tiled,
                                            tile_edges)
from repro.kernels.segment_spmm.ref import segment_sum_dense

from _gnn_cases import (SPMM_EDGE_CASES, SPMM_SWEEP, SPMM_TOL, edge_inputs,
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
