"""Inputs of the intersect, delta_vlen and varint fetch codec kernel
tests, made with numpy from fixed seeds: the reference's kernel sweep
shapes, sentinel-padded windows (the bucketed layout's), and full rows;
for intersect's final-run rule also rows whose final run is long and not
the sentinel, rows of one value, all-sentinel rows, ``a`` below
``b[0]``, M of 2, 3 and 5, and a live prefix longer than the kernel's
4,096-id shared-memory stage.  Values stay inside (INT32_MIN,
INT32_MAX), which the Pallas wrapper pads with.  The codec cases are
``tests/test_torch_wire.py``'s lane shapes and draws, and edge cases of
the row codec.  Free of JAX, so the card-only tests and
``chip_smoke.py`` can use them where JAX is not installed."""
import numpy as np

INTERSECT_SWEEP = [(5, 20), (33, 129), (128, 64), (17, 8), (40, 65), (9, 200)]
INTERSECT_FINAL_RUN = [("final_run", (40, 37)), ("one_value", (40, 37)),
                       ("all_sentinel", (40, 37)), ("below_first", (40, 37)),
                       ("narrow", (50, 2)), ("narrow", (50, 3)),
                       ("narrow", (50, 5)), ("long_prefix", (2, 4200))]
# card only: a row longer than any stage, B = 1, and INT32_MIN/INT32_MAX
INTERSECT_CARD_CASES = [("long_prefix", (2, 20000)), ("padded", (1, 1780)),
                        ("extremes", (40, 37))]
INTERSECT_CASES = ([("sweep", s) for s in INTERSECT_SWEEP]
                   + [("padded", s) for s in ((64, 37), (300, 16), (7, 1))]
                   + INTERSECT_FINAL_RUN)
DELTA_VLEN_SWEEP = [(3, 16), (7, 130), (260, 64), (1, 300)]


def intersect_inputs(kind, B, M):
    """Sorted rows ``a``, ``b`` (B, M) and the sentinel: the reference
    sweep's draws (``test_intersect_sweep``), or sentinel-padded windows
    of random degree."""
    rng = np.random.default_rng(B + M)      # as tests/test_kernels.py
    sent = 500
    a = np.sort(rng.integers(0, sent, (B, M)).astype(np.int32), axis=1)
    b = np.sort(rng.integers(0, sent, (B, M)).astype(np.int32), axis=1)
    col = np.arange(M)
    if kind == "padded":
        a = np.where(col < rng.integers(0, M + 1, (B, 1)), a, sent)
        b = np.where(col < rng.integers(0, M + 1, (B, 1)), b, sent)
    elif kind == "narrow":             # M not 4-aligned, half of a from b
        a = np.sort(np.where(rng.random((B, M)) < 0.5, b, a), axis=1)
        a = np.where(col < rng.integers(0, M + 1, (B, 1)), a, sent)
        b = np.where(col < rng.integers(0, M + 1, (B, 1)), b, sent)
    elif kind == "final_run":          # b's last id repeated, not sentinel
        b = np.where(col >= rng.integers(0, M, (B, 1)), b[:, -1:], b)
        a = np.sort(np.where(rng.random((B, M)) < 0.5, b, a), axis=1)
    elif kind == "one_value":
        b = np.repeat(rng.integers(0, 20, (B, 1)), M, axis=1)
        a = np.sort(rng.integers(0, 20, (B, M)), axis=1)
    elif kind == "all_sentinel":       # some rows of a all sentinel too
        b = np.full((B, M), sent)
        a = np.where(col < rng.integers(0, M + 1, (B, 1)), a, sent)
    elif kind == "below_first":        # b starts high, a mostly below it
        b = b + 400
        a = np.sort(np.where(rng.random((B, M)) < 0.3, b,
                             rng.integers(-1000, 450, (B, M))), axis=1)
        sent = 2000
    elif kind == "extremes":           # card only: the Pallas pad values
        lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
        b = np.sort(rng.integers(lo, hi, (B, M), endpoint=True), axis=1)
        b[:5, 0], b[5:10, -1], b[10:15] = lo, hi, hi
        b = np.sort(b, axis=1)
        a = np.where(rng.random((B, M)) < 0.5, b,
                     rng.integers(lo, hi, (B, M), endpoint=True))
        a[:, 0], a[:, 1] = lo, hi
        a = np.sort(a, axis=1)
        sent = hi
    elif kind == "long_prefix":        # L > 4,096: searched in global memory
        sent = 1 << 20
        b = np.sort(rng.choice(sent, (B, M)), axis=1)
        b[:, M - M // 60:] = sent
        a = np.sort(np.where(rng.random((B, M)) < 0.5, b,
                             rng.integers(0, sent + 1, (B, M))), axis=1)
    return a.astype(np.int32), b.astype(np.int32), sent


def delta_vlen_inputs(B, M):
    """Sorted-with-holes id lanes over a universe of 2^27 (the reference
    sweep's draws)."""
    rng = np.random.default_rng(B * M)      # as tests/test_kernels.py
    n = 1 << 27
    ids = np.full((B, M), n, np.int32)
    for r in range(B):
        k = int(rng.integers(0, M + 1))
        vals = np.sort(rng.choice(n, size=k, replace=False)).astype(np.int32)
        ids[r, np.sort(rng.choice(M, k, replace=False))] = vals
    return ids, n


def id_lanes(rng, lanes, m, n, hole_p=0.4):
    """Request id lanes: ascending ids below ``n`` with sentinel holes
    (``test_torch_wire.py``'s draws)."""
    out = np.full(lanes + (m,), n, np.int32)
    for idx in np.ndindex(*lanes):
        keep = rng.random(m) >= hole_p
        k = int(keep.sum())
        out[idx][keep] = np.sort(rng.choice(min(n, 10 * m + 50), k,
                                            replace=False))
    return out


def row_lanes(rng, lanes, m, D, n, prefix=True, full=False):
    """Adjacency window lanes (sorted, sentinel ``n`` padded) and their
    valid rows: a prefix, or random rows (``test_torch_wire.py``'s
    draws)."""
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


def _holes_with_empty_lane(rng):
    ids = id_lanes(rng, (2, 3), 48, 10 ** 6)
    ids[1, 2] = 10 ** 6
    return ids, 10 ** 6, 4 * 48


# name -> rng -> (ids (ndev, peer, M), sentinel, cap), drawn with
# default_rng(0): test_torch_wire.py's ID_CASES, then a lane of several
# kernel tiles
CODEC_ID_CASES = {
    "holes": _holes_with_empty_lane,
    "raw_escape": lambda rng: (np.array(
        [[[(1 << 28) + 1, (1 << 29) + 7] + [1 << 30] * 6,
          [5, (1 << 29) + 7] + [1 << 30] * 6]], np.int32), 1 << 30, 32),
    "overflow": lambda rng: (id_lanes(rng, (1, 2), 16, 1000, 0.0), 1000, 8),
    "long_lanes": lambda rng: (id_lanes(rng, (1, 3), 2500, 1 << 24, 0.3),
                               1 << 24, 4 * 2500),
}


def _interior_sentinel(rng):
    """Valid rows with a sentinel inside their first ``deg`` columns (the
    degree counts entries below the sentinel; it is not where the first
    sentinel stands), a valid row with no entry, and one lane with no
    valid row at all."""
    n = 1 << 20
    rows, valid = row_lanes(rng, (2, 2), 6, 7, n, prefix=False)
    rows[0, 0, 1] = [5, n, 7, 9, 3, n, n]
    rows[0, 1, 0] = [n, 4, 8, n, 2, 1, n]
    rows[1, 0, 2] = n
    valid[0, 0, 1] = valid[0, 1, 0] = valid[1, 0, 2] = True
    valid[1, 1] = False
    return rows, valid, n, 12, 4 * 7 * 6


def _wide_big_ids(rng):
    """D = 1,780 (the full cell's max degree) rows of ids >= 2^28: five
    varint bytes a first id, so some lanes escape to raw."""
    n = 1 << 30
    rows = np.full((1, 2, 3, 1780), n, np.int32)
    valid = np.zeros((1, 2, 3), bool)
    for t in range(2):
        for r in range(3):
            if rng.random() < 0.8:
                valid[0, t, r] = True
                d = int(rng.integers(1, 1781))
                rows[0, t, r, :d] = (1 << 28) + np.sort(rng.choice(
                    n - (1 << 28), d, replace=False))
    return rows, valid, n, 6, 4 * 1780 * 3


def _unsorted_rows(rng):
    """Rows out of order: the row codec takes consecutive differences
    (clamped at 0), not delta_vlen's running maximum, and the two give
    different streams on them."""
    n = 5000
    rows = np.full((1, 1, 2, 6), n, np.int32)
    rows[0, 0, 0] = [9, 3, 4, 12, 8, 30]
    rows[0, 0, 1, :3] = [100, 40, 41]
    return rows, np.ones((1, 1, 2), bool), n, 4, 4 * 6 * 2


# name -> rng -> (rows (ndev, peer, m, D), valid (ndev, peer, m), sentinel,
# degs_cap, ids_cap), drawn with default_rng(2): test_torch_wire.py's
# ROW_CASES, then the row codec's edge cases and a lane of several tiles
CODEC_ROW_CASES = {
    "prefix": lambda rng: (*row_lanes(rng, (2, 3), 12, 16, 10 ** 5), 10 ** 5,
                           24, 4 * 16 * 12),
    "holes": lambda rng: (*row_lanes(rng, (2, 2), 10, 9, 5000, False),
                          5000, 20, 4 * 9 * 10),
    "raw_escape": lambda rng: (np.array([[[[(1 << 21) + 3], [(1 << 22) + 1],
                                           [1 << 30]]]], np.int32),
                               np.array([[[True, True, False]]]), 1 << 30,
                               6, 12),
    "overflow": lambda rng: (*row_lanes(rng, (1, 2), 6, 8, 900, full=True),
                             900, 12, 40),
    "interior_sentinel": _interior_sentinel,
    "wide_big_ids": _wide_big_ids,
    "unsorted_rows": _unsorted_rows,
    "many_tiles": lambda rng: (*row_lanes(rng, (1, 2), 150, 24, 5000, False),
                               5000, 300, 4 * 24 * 150),
}


ARBITRARY_STREAM_SEEDS = (0, 1, 2, 3)


def arbitrary_row_streams(seed):
    """Row streams no encoder writes, for the decoder alone: random bytes
    (most of them terminators), lengths below 0 and past the caps, coded
    and raw lanes, so values are cut off, degrees run past m·D or wrap,
    and rows read past the last value.  Returns ``((degs_s, degs_len,
    ids_s, ids_len, raw) with lanes (1, 3), valid (1, 3, m), m, D)``."""
    rng = np.random.default_rng(100 + seed)
    L, m, D = 3, int(rng.integers(1, 40)), int(rng.integers(1, 20))
    dcap, icap = int(rng.integers(1, 90)), int(rng.integers(1, 700))

    def stream(cap, small):
        s = rng.integers(0, 256, (L, cap)).astype(np.uint8)
        s[rng.random((L, cap)) < 0.55] &= 0x7F
        if small:
            s = np.where(rng.random((L, cap)) < 0.5, s & 0x0F, s)
        return s.astype(np.uint8)

    streams = (stream(dcap, True),
               rng.integers(-3, dcap + 5, L).astype(np.int32),
               stream(icap, False),
               rng.integers(-3, icap + 5, L).astype(np.int32),
               rng.random(L) < 0.3)
    valid = rng.random((L, m)) < 0.5
    return tuple(x[None] for x in streams), valid[None], m, D
