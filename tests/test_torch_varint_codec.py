"""The varint fetch codec's entry points (``repro_torch.kernels.varint.ops``)
on the CPU, where they run their plain versions, against the
reference's lane codecs (``repro.core.wire``): every stream, length, raw
and overflow flag, modeled size and decoded row is equal, byte for byte,
on ``tests/test_torch_wire.py``'s lanes and the row codec's edge cases
(``tests/_codec_cases.py``).  The kernels themselves are held against
the plain versions on the card in ``test_torch_gpu.py`` and
``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire as ref
from repro.kernels.varint.ref import delta_vlen_ref as jax_delta_vlen

from _codec_cases import (ARBITRARY_STREAM_SEEDS, CODEC_ID_CASES,
                          CODEC_ROW_CASES, arbitrary_row_streams)
from repro_torch.kernels.varint import ops

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=msg)


@pytest.mark.parametrize("case", sorted(CODEC_ID_CASES))
def test_encode_ids_matches_reference(case):
    ids, n, cap = CODEC_ID_CASES[case](np.random.default_rng(0))
    want = jax.jit(lambda w: ref.encode_ids_lanes(w, n, cap))(
        jnp.asarray(ids))
    lead = ids.shape[:-1]
    got = ops.encode_ids(torch.as_tensor(ids.reshape(-1, ids.shape[-1])), n,
                         cap)
    stream, length, raw, overflow, model = (x.view(lead + x.shape[1:])
                                            for x in got)
    for name, g, w in zip(("stream", "len", "raw", "model"),
                          (stream, length, raw, model),
                          (want[0], want[1], want[2], want[4])):
        _eq(g, w, name)
    assert bool(overflow.any()) == bool(want[3])


def _encode_both(case):
    """Both packages' encoders on one case; the reference's outputs end
    with its decoded rows and those rows on the requester's slots (one
    jit for all three)."""
    rows, valid, n, dcap, icap = CODEC_ROW_CASES[case](
        np.random.default_rng(2))
    m, D = rows.shape[-2:]

    def reference(x, v):
        enc = ref.encode_rows_lanes(x, v, n, dcap, icap)
        dec = ref.decode_rows_lanes(*enc[:5], m, D, n)
        return (*enc, dec, ref.scatter_compacted_lanes(dec, v, n))

    want = jax.jit(reference)(jnp.asarray(rows), jnp.asarray(valid))
    got = ops.encode_rows(torch.as_tensor(rows.reshape(-1, m, D)),
                          torch.as_tensor(valid.reshape(-1, m)), n, dcap,
                          icap)
    return rows, valid, n, want, got


@pytest.mark.parametrize("case", sorted(CODEC_ROW_CASES))
def test_rows_codec_matches_reference(case):
    """encode_rows, then decode_rows compacted and straight onto the
    requester's slots (the reference's decode then scatter_compacted)."""
    rows, valid, n, want, got = _encode_both(case)
    lead, (m, D) = valid.shape[:-1], rows.shape[-2:]
    got = [x.view(lead + x.shape[1:]) for x in got]
    for name, g, w in zip(("degs", "degs_len", "ids", "ids_len", "raw"),
                          got, want):
        _eq(g, w, name)
    assert bool(got[5].any()) == bool(want[5])
    rd, scattered = want[6:]
    _eq(ops.decode_rows(*got[:5], m, D, n), rd, "decoded rows")
    _eq(ops.decode_rows(*got[:5], m, D, n, valid=torch.as_tensor(valid)),
        scattered, "decoded onto the slots")
    out = torch.full(lead + (m, D), -7, dtype=torch.int32)
    ops.decode_rows(*got[:5], m, D, n, valid=torch.as_tensor(valid), out=out)
    _eq(out, scattered, "decoded into out")


@pytest.mark.parametrize("seed", ARBITRARY_STREAM_SEEDS)
def test_decode_rows_matches_reference_on_arbitrary_streams(seed):
    """Streams no encoder writes (cut values, degrees past m·D, lengths
    out of range) decode as the reference decodes them."""
    streams, valid, m, D = arbitrary_row_streams(seed)

    def reference(*x):
        dec = ref.decode_rows_lanes(*x[:5], m, D, 77)
        return dec, ref.scatter_compacted_lanes(dec, x[5], 77)

    want = jax.jit(reference)(*(jnp.asarray(x) for x in streams + (valid,)))
    got = [torch.as_tensor(x) for x in streams]
    _eq(ops.decode_rows(*got, m, D, 77), want[0], "decoded rows")
    _eq(ops.decode_rows(*got, m, D, 77, valid=torch.as_tensor(valid)),
        want[1], "decoded onto the slots")


def test_row_codec_and_delta_vlen_take_different_deltas():
    """On an unsorted row the row codec codes consecutive differences
    (clamped at 0) and delta_vlen the difference to the running maximum:
    each package follows each rule, and the rules differ there."""
    rows, _, n, want, got = _encode_both("unsorted_rows")
    row = rows[0, 0, 0]
    consecutive = np.maximum(np.diff(row, prepend=0), 0)
    delta, vlen = ops.delta_vlen(torch.as_tensor(row[None]), n)
    _eq(delta[0], np.asarray(jax_delta_vlen(jnp.asarray(row[None]), n)[0][0]))
    assert not np.array_equal(delta[0].numpy(), consecutive)
    # every delta of both rows is below 128: one byte each
    ids_s = got[2][0].numpy()
    _eq(ids_s[:6], consecutive.astype(np.uint8), "row codec deltas")
    _eq(ids_s[:9], np.asarray(want[2])[0, 0, :9], "the reference's stream")


def test_cpu_codecs_launch_nothing():
    before = dict(ops.launches_by_variant), ops.launches
    _encode_both("holes")
    ops.encode_ids(torch.zeros((2, 5), dtype=torch.int32), 9, 20)
    assert (dict(ops.launches_by_variant), ops.launches) == before


def test_decode_rows_rejects_bad_inputs():
    s = torch.zeros((2, 8), dtype=torch.uint8)
    n = torch.zeros(2, dtype=torch.int32)
    raw = torch.zeros(2, dtype=torch.bool)
    with pytest.raises(TypeError):
        ops.decode_rows(s, n, s.int(), n, raw, 2, 3, 9)
    with pytest.raises(ValueError):
        ops.decode_rows(s, n, s, n, raw, 2, 3, 9,
                        out=torch.zeros((2, 2, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.decode_rows(s[None, None], n[None, None], s[None, None],
                        n[None, None], raw[None, None], 2, 3, 9)
