"""The port's intersect kernel module: its plain PyTorch version against
the reference's ``intersect_ref`` and Pallas kernel (interpret mode) at
the reference's sweep shapes and on sentinel-padded windows, and the
wrapper's input checks.  The kernel itself is held against the plain
version on the card in ``test_torch_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.intersect.kernel import intersect_pallas
from repro.kernels.intersect.ref import intersect_ref as jax_ref

from _codec_cases import INTERSECT_CASES, intersect_inputs
from repro_torch.kernels.intersect import ops

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)


@pytest.mark.parametrize("kind,shape", INTERSECT_CASES)
def test_plain_matches_reference_and_pallas(kind, shape):
    a, b, sent = intersect_inputs(kind, *shape)
    want = [np.asarray(x) for x in jax_ref(jnp.asarray(a), jnp.asarray(b),
                                           sent)]
    pallas = [np.asarray(x) for x in intersect_pallas(
        jnp.asarray(a), jnp.asarray(b), sent, interpret=True)]
    mask, count = ops.intersect(torch.as_tensor(a), torch.as_tensor(b), sent)
    assert mask.dtype == torch.bool and count.dtype == torch.int32
    for got, w, p in zip((mask, count), want, pallas):
        np.testing.assert_array_equal(got.numpy(), w)
        np.testing.assert_array_equal(got.numpy(), p)


def test_sentinel_is_never_a_member():
    """Unlike membership, a sentinel entry of ``a`` is absent even where
    ``b`` is padded with the sentinel."""
    b = torch.tensor([[1, 4, 9, 9]], dtype=torch.int32)
    a = torch.tensor([[9, 4, 2, 1]], dtype=torch.int32)
    mask, count = ops.intersect(a, b, 9)
    assert mask.tolist() == [[False, True, False, True]]
    assert count.tolist() == [2]


def test_wrapper_rejects_bad_inputs():
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.intersect(a.long(), a, 9)
    with pytest.raises(ValueError):
        ops.intersect(a[0], a[0], 9)                     # rank 1
    with pytest.raises(ValueError):
        ops.intersect(a, a[:3], 9)                       # shape mismatch
    with pytest.raises(ValueError):
        ops.intersect(a[:, :0].contiguous(), a[:, :0].contiguous(), 9)
    with pytest.raises(ValueError):
        t = torch.zeros((8, 4), dtype=torch.int32).t()
        ops.intersect(t, t, 9)


def test_cpu_path_launches_nothing():
    before = ops.launches
    a, b, sent = intersect_inputs("sweep", 5, 20)
    ops.intersect(torch.as_tensor(a), torch.as_tensor(b), sent)
    assert ops.launches == before
