"""The port's membership kernel module: its plain PyTorch version against
the reference's ``membership_ref`` and Pallas kernel (interpret mode), the
wrapper's input checks.  The kernel itself is held against the plain
version on the card in ``test_torch_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.membership.kernel import membership_pallas
from repro.kernels.membership.ref import membership_ref as jax_ref

from _membership_cases import CASES, SWEEP, edge_inputs, sweep_inputs
from repro_torch.kernels.membership import ops

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)


@pytest.mark.parametrize("kind,arg", CASES)
def test_plain_matches_reference_and_pallas(kind, arg):
    rows, vals = sweep_inputs(*arg) if kind == "sweep" else edge_inputs(arg)
    want = np.asarray(jax_ref(jnp.asarray(rows), jnp.asarray(vals)))
    pallas = np.asarray(membership_pallas(jnp.asarray(rows),
                                          jnp.asarray(vals), interpret=True))
    got = ops.membership(torch.as_tensor(rows), torch.as_tensor(vals))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_wrapper_rejects_bad_inputs():
    rows = torch.zeros((4, 8), dtype=torch.int32)
    vals = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.membership(rows.long(), vals)
    with pytest.raises(TypeError):
        ops.membership(rows, vals.float())
    with pytest.raises(ValueError):
        ops.membership(rows[0], vals)                    # rank 1
    with pytest.raises(ValueError):
        ops.membership(rows, vals[:3])                   # batch mismatch
    with pytest.raises(ValueError):
        ops.membership(rows[:, :0].contiguous(), vals)   # M = 0
    with pytest.raises(ValueError):
        ops.membership(torch.zeros((8, 4), dtype=torch.int32).t(), vals)


def test_cpu_path_launches_nothing():
    before = ops.launches
    rows, vals = sweep_inputs(*SWEEP[0])
    ops.membership(torch.as_tensor(rows), torch.as_tensor(vals))
    assert ops.launches == before
