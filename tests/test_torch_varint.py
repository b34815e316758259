"""The port's delta_vlen kernel module: its plain PyTorch version against
the reference's ``delta_vlen_ref`` and Pallas kernel (interpret mode) at
the reference's sweep shapes, the LEB128 sizing ladder, and the
wrapper's input checks.  The kernel itself is held against the plain
version on the card in ``test_torch_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.varint.kernel import delta_vlen_pallas
from repro.kernels.varint.ref import delta_vlen_ref as jax_ref
from repro.kernels.varint.ref import varint_size as jax_size

from _codec_cases import DELTA_VLEN_SWEEP, delta_vlen_inputs
from repro_torch.kernels.varint import ops
from repro_torch.kernels.varint.ref import varint_size

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)


@pytest.mark.parametrize("B,M", DELTA_VLEN_SWEEP)
def test_plain_matches_reference_and_pallas(B, M):
    ids, n = delta_vlen_inputs(B, M)
    want = [np.asarray(x) for x in jax_ref(jnp.asarray(ids), n)]
    pallas = [np.asarray(x) for x in delta_vlen_pallas(jnp.asarray(ids), n,
                                                       interpret=True)]
    got = ops.delta_vlen(torch.as_tensor(ids), n)
    for g, w, p in zip(got, want, pallas):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(g.numpy(), p)


def test_varint_size_ladder():
    edges = [0, 1, 127, 128, 16383, 16384, (1 << 21) - 1, 1 << 21,
             (1 << 28) - 1, 1 << 28, (1 << 31) - 1]
    v = np.asarray(edges, np.int32)
    got = varint_size(torch.as_tensor(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_size(jnp.asarray(v))))
    assert got.tolist() == [1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5]


def test_unsorted_and_negative_deltas_clamp():
    """Out-of-order valid ids give delta 0 against the running maximum, as
    the reference's clamp does; holes stay 0."""
    ids = np.array([[5, 3, 9, 50, 4, 50]], np.int32)
    want = [np.asarray(x) for x in jax_ref(jnp.asarray(ids), 50)]
    got = ops.delta_vlen(torch.as_tensor(ids), 50)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_wrapper_rejects_bad_inputs():
    ids = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.delta_vlen(ids.long(), 9)
    with pytest.raises(ValueError):
        ops.delta_vlen(ids[0], 9)
    with pytest.raises(ValueError):
        ops.delta_vlen(ids.t(), 9)


def test_cpu_path_launches_nothing():
    before = ops.launches
    ids, n = delta_vlen_inputs(3, 16)
    ops.delta_vlen(torch.as_tensor(ids), n)
    assert ops.launches == before
