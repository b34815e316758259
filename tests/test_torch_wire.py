"""The port's wire codecs (``repro_torch.core.wire``) against the
reference's ``repro.core.wire`` on the same lanes, made with numpy from
fixed seeds: every stream, length, raw flag, overflow flag and decoded
payload is equal, byte for byte — sentinel holes, empty lanes, the raw
escape and overflowing lanes included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire as ref

from repro_torch.core import wire

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _both(fn_ref, fn, *arrays, **kw):
    """Run both packages on the same numpy inputs; return both results."""
    r = fn_ref(*(jnp.asarray(a) for a in arrays), **kw)
    g = fn(*(torch.as_tensor(a) for a in arrays), **kw)
    return r, g


def _id_lanes(rng, lanes, m, n, hole_p=0.4):
    out = np.full(lanes + (m,), n, np.int32)
    for idx in np.ndindex(*lanes):
        keep = rng.random(m) >= hole_p
        k = int(keep.sum())
        out[idx][keep] = np.sort(rng.choice(min(n, 10 * m + 50), k,
                                            replace=False))
    return out


ID_CASES = {
    # sorted ids with holes, one empty lane
    "holes": lambda rng: (_id_lanes(rng, (2, 3), 48, 10 ** 6), 10 ** 6,
                          4 * 48),
    # deltas >= 2^28: a lane that escapes to raw and one that stays coded
    "raw_escape": lambda rng: (np.array(
        [[[(1 << 28) + 1, (1 << 29) + 7] + [1 << 30] * 6,
          [5, (1 << 29) + 7] + [1 << 30] * 6]], np.int32), 1 << 30, 32),
    # a lane whose raw form does not fit its stream: overflow
    "overflow": lambda rng: (_id_lanes(rng, (1, 2), 16, 1000, 0.0), 1000, 8),
}


@pytest.mark.parametrize("case", sorted(ID_CASES))
def test_id_lanes_match_reference(case):
    ids, n, cap = ID_CASES[case](np.random.default_rng(0))
    if case == "holes":
        ids[1, 2] = n                                    # an empty lane
    r, g = _both(jax.jit(lambda w: ref.encode_ids_lanes(w, n, cap)),
                 lambda w: wire.encode_ids_lanes(w, n, cap), ids)
    for name, a, b in zip(("stream", "len", "raw", "overflow", "model"),
                          g, r):
        _eq(a, b, name)
    if case == "raw_escape":
        assert g[2].tolist() == [[True, False]]
    if case == "overflow":
        assert bool(g[3])
    m = ids.shape[-1]
    rd = jax.jit(lambda *x: ref.decode_ids_lanes(*x, m, n))(*r[:3])
    gd = wire.decode_ids_lanes(*g[:3], m, n)
    for name, a, b in zip(("ids", "mask"), gd, rd):
        _eq(a, b, name)


def test_single_lane_ids_match_reference():
    ids = _id_lanes(np.random.default_rng(1), (), 40, 5000)
    r = ref.encode_ids(jnp.asarray(ids), 5000, 160)
    g = wire.encode_ids(torch.as_tensor(ids), 5000, 160)
    for a, b in zip(g, r):
        _eq(a, b)
    for a, b in zip(wire.decode_ids(*g[:3], 40, 5000),
                    ref.decode_ids(*r[:3], 40, 5000)):
        _eq(a, b)


def _single_lane(codec):
    """One lane through the per-lane API of both packages: (reference
    outputs, port outputs), encode then decode."""
    rng = np.random.default_rng(5)
    if codec == "rows":
        rows, valid = _row_lanes(rng, (), 9, 7, 3000, prefix=False)
        r = ref.encode_rows(jnp.asarray(rows), jnp.asarray(valid), 3000, 18,
                            252)
        g = wire.encode_rows(torch.as_tensor(rows), torch.as_tensor(valid),
                             3000, 18, 252)
        rd = ref.decode_rows(*r[:5], 9, 7, 3000)
        gd = wire.decode_rows(*g[:5], 9, 7, 3000)
        return ((*r, rd, ref.scatter_compacted(rd, jnp.asarray(valid), 3000)),
                (*g, gd, wire.scatter_compacted(gd, torch.as_tensor(valid),
                                                3000)))
    if codec == "pairs":
        a, b = _pair_lanes(rng, (), 30, 10 ** 4, 40, 10 ** 4)
        k = int((a < 10 ** 4).sum())
        r = ref.encode_pairs(jnp.asarray(a), jnp.asarray(b), 10 ** 4, 120, 120)
        g = wire.encode_pairs(torch.as_tensor(a), torch.as_tensor(b), 10 ** 4,
                              120, 120)
        return ((*r, *ref.decode_pairs(*r[:5], jnp.int32(k), 30, 10 ** 4,
                                       10 ** 4)),
                (*g, *wire.decode_pairs(*g[:5], k, 30, 10 ** 4, 10 ** 4)))
    bits = rng.random(21) < 0.5
    r = ref.pack_bools(jnp.asarray(bits), jnp.int32(13), 3)
    g = wire.pack_bools(torch.as_tensor(bits), 13, 3)
    return ((*r, ref.unpack_bools(r[0], jnp.int32(13), 21)),
            (*g, wire.unpack_bools(g[0], 13, 21)))


@pytest.mark.parametrize("codec", ["rows", "pairs", "bools"])
def test_single_lane_codecs_match_reference(codec):
    want, got = _single_lane(codec)
    assert len(got) == len(want)
    for i, (x, y) in enumerate(zip(got, want)):
        _eq(x, y, f"{codec} output {i}")


def _row_lanes(rng, lanes, m, D, n, prefix=True, full=False):
    rows = np.full(lanes + (m, D), n, np.int32)
    valid = np.zeros(lanes + (m,), bool)
    for idx in np.ndindex(*lanes):
        k = m if full else int(rng.integers(0, m + 1))
        sel = (np.arange(m) < k) if prefix else rng.random(m) < 0.6
        valid[idx] = sel
        for i in np.flatnonzero(sel):
            d = D if full else int(rng.integers(0, D + 1))
            rows[idx][i, :d] = np.sort(rng.choice(n, d, replace=False))
    return rows, valid


ROW_CASES = {
    "prefix": lambda rng: (*_row_lanes(rng, (2, 3), 12, 16, 10 ** 5), 10 ** 5,
                           24, 4 * 16 * 12),
    "holes": lambda rng: (*_row_lanes(rng, (2, 2), 10, 9, 5000, False),
                          5000, 20, 4 * 9 * 10),
    # one-column rows of ids >= 2^21: 1 + 4 coded bytes > 4 raw bytes
    "raw_escape": lambda rng: (np.array([[[[(1 << 21) + 3], [(1 << 22) + 1],
                                           [1 << 30]]]], np.int32),
                               np.array([[[True, True, False]]]), 1 << 30,
                               6, 12),
    # a stream cap below even the raw rows: overflow
    "overflow": lambda rng: (*_row_lanes(rng, (1, 2), 6, 8, 900, full=True),
                             900, 12, 40),
}


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_row_lanes_match_reference(case):
    rows, valid, n, dcap, icap = ROW_CASES[case](np.random.default_rng(2))
    r, g = _both(jax.jit(lambda x, v: ref.encode_rows_lanes(x, v, n, dcap,
                                                            icap)),
                 lambda x, v: wire.encode_rows_lanes(x, v, n, dcap, icap),
                 rows, valid)
    for name, a, b in zip(("degs", "degs_len", "ids", "ids_len", "raw",
                           "overflow"), g, r):
        _eq(a, b, name)
    if case == "raw_escape":
        assert bool(g[4].all())
    if case == "overflow":
        assert bool(g[5])
    m, D = rows.shape[-2:]
    rd = jax.jit(lambda *x: ref.decode_rows_lanes(*x, m, D, n))(*r[:5])
    gd = wire.decode_rows_lanes(*g[:5], m, D, n)
    _eq(gd, rd, "decoded rows")
    # the requester spreads the compacted rows back onto its slots
    rs = ref.scatter_compacted_lanes(rd, jnp.asarray(valid), n)
    gs = wire.scatter_compacted_lanes(gd, torch.as_tensor(valid), n)
    _eq(gs, rs, "scattered rows")
    if case != "overflow":
        _eq(gs, np.where(valid[..., None], rows, n), "roundtrip")


def _pair_lanes(rng, lanes, m, n, hi_a, hi_b):
    a = np.full(lanes + (m,), n, np.int32)
    b = np.full(lanes + (m,), n, np.int32)
    for idx in np.ndindex(*lanes):
        k = int(rng.integers(0, m + 1))
        pairs = sorted({(int(rng.integers(0, hi_a)),
                         int(rng.integers(0, hi_b))) for _ in range(k)})
        a[idx][:len(pairs)] = [p[0] for p in pairs]
        b[idx][:len(pairs)] = [p[1] for p in pairs]
    return a, b


PAIR_CASES = {
    "runs": lambda rng: (*_pair_lanes(rng, (2, 3), 40, 10 ** 5, 60, 10 ** 5),
                         10 ** 5, 160, 160),
    "spread": lambda rng: (*_pair_lanes(rng, (2, 2), 33, 10 ** 6, 10 ** 6,
                                        10 ** 6), 10 ** 6, 132, 132),
    # b >= 2^28 costs 5 varint bytes: a lone pair escapes to raw
    "raw_escape": lambda rng: (np.array([[[7, 1 << 30], [5, 1 << 30]]],
                                        np.int32),
                               np.array([[[(1 << 29) + 3, 1 << 30],
                                          [2, 1 << 30]]], np.int32),
                               1 << 30, 8, 8),
    # stream caps below the raw pairs: overflow
    "overflow": lambda rng: (*_pair_lanes(rng, (1, 2), 20, 1000, 900, 900),
                             1000, 6, 6),
}


@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_pair_lanes_match_reference(case):
    a, b, n, acap, bcap = PAIR_CASES[case](np.random.default_rng(3))
    r, g = _both(jax.jit(lambda x, y: ref.encode_pairs_lanes(x, y, n, acap,
                                                             bcap)),
                 lambda x, y: wire.encode_pairs_lanes(x, y, n, acap, bcap),
                 a, b)
    for name, x, y in zip(("a", "a_len", "b", "b_len", "raw", "overflow"),
                          g, r):
        _eq(x, y, name)
    if case == "raw_escape":
        assert g[4].tolist() == [[True, False]]
    if case == "overflow":
        assert bool(g[5])
    counts = (a < n).sum(-1).astype(np.int32)
    m = a.shape[-1]
    rd = jax.jit(lambda *x: ref.decode_pairs_lanes(*x, m, n, n))(
        *r[:5], jnp.asarray(counts))
    gd = wire.decode_pairs_lanes(*g[:5], torch.as_tensor(counts), m, n, n)
    for name, x, y in zip(("a", "b", "mask"), gd, rd):
        _eq(x, y, name)
    if case != "overflow":
        _eq(gd[0], a, "a roundtrip")
        _eq(gd[1], b, "b roundtrip")


@pytest.mark.parametrize("m,cap", [(19, 3), (64, 8), (7, 1)])
def test_bool_lanes_match_reference(m, cap):
    rng = np.random.default_rng(m)
    bits = rng.random((2, 3, m)) < 0.5
    counts = rng.integers(0, m + 1, (2, 3)).astype(np.int32)
    r = jax.jit(lambda b, c: ref.pack_bools_lanes(b, c, cap))(
        jnp.asarray(bits), jnp.asarray(counts))
    g = wire.pack_bools_lanes(torch.as_tensor(bits), torch.as_tensor(counts),
                              cap)
    for x, y in zip(g, r):
        _eq(x, y)
    _eq(wire.unpack_bools_lanes(g[0], torch.as_tensor(counts), m),
        ref.unpack_bools_lanes(r[0], jnp.asarray(counts), m))


def test_lane_groups_do_not_change_results(monkeypatch):
    """The lane wrappers give the same outputs when run one lane at a
    time (the memory bound at the escalated capacities)."""
    rows, valid = _row_lanes(np.random.default_rng(4), (2, 3), 12, 16, 10 ** 5)
    args = (torch.as_tensor(rows), torch.as_tensor(valid), 10 ** 5, 24, 768)
    whole = wire.encode_rows_lanes(*args)
    monkeypatch.setattr(wire, "CODEC_CHUNK_ELEMS", 1)
    grouped = wire.encode_rows_lanes(*args)
    for x, y in zip(grouped, whole):
        _eq(x, y.numpy())
    _eq(wire.decode_rows_lanes(*grouped[:5], 12, 16, 10 ** 5),
        wire.decode_rows_lanes(*whole[:5], 12, 16, 10 ** 5).numpy())


def test_stream_caps_match_reference():
    for fcap, D in ((256, 16), (32768, 1780)):
        assert wire.fetch_stream_caps(fcap, D) == ref.fetch_stream_caps(fcap,
                                                                        D)
    for vcap in (1024, 131072, 5):
        assert wire.verify_stream_caps(vcap) == ref.verify_stream_caps(vcap)


def _trial(s):
    return {"pipeline_s": s, "wire_bytes": 100}


# (requested, mode, prior): every branch of the auto selection, the
# hysteresis anchor on either side of its 5% band included
WIRE_PRIORS = [
    ("varint", "sim", None),                                    # explicit
    ("auto", "sim", None),                                      # heuristic
    ("auto", "spmd", {}),
    ("auto", "dist", {"wire_trials": {}}),
    ("auto", "sim", {"wire_trials": {"sim:raw": _trial(1.0)}}),  # explore
    ("auto", "sim", {"wire_trials": {"sim:varint": _trial(1.0)}}),
    ("auto", "sim", {"wire_trials": {"spmd:raw": _trial(1.0)}}),
    ("auto", "sim", {"wire_trials": {"sim:raw": _trial(1.0),    # measured
                                     "sim:varint": _trial(2.0)}}),
    ("auto", "sim", {"wire_trials": {"sim:raw": _trial(3.0),
                                     "sim:varint": _trial(2.0)}}),
    ("auto", "sim", {"wire_trials": {"sim:raw": _trial(1.0),    # hysteresis
                                     "sim:varint": _trial(0.97)},
                     "wire_choice": {"sim": "raw"}}),
    ("auto", "sim", {"wire_trials": {"sim:raw": _trial(1.0),
                                     "sim:varint": _trial(0.90)},
                     "wire_choice": {"sim": "raw"}}),
    ("auto", "sim", {"wire_trials": {"sim:raw": _trial(0.98),
                                     "sim:varint": _trial(1.0)},
                     "wire_choice": {"sim": "varint"}}),
]


@pytest.mark.parametrize("requested,mode,prior", WIRE_PRIORS)
def test_resolve_wire_format_matches_reference(requested, mode, prior):
    """On the same fixed priors both packages pick the same codec for the
    same reason; only recorded wall times can make two runs differ."""
    assert (wire.resolve_wire_format(requested, mode, prior)
            == ref.resolve_wire_format(requested, mode, prior))
