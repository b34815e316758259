"""Inputs of the intersect and delta_vlen kernel tests, made with numpy
from fixed seeds: the reference's kernel sweep shapes, sentinel-padded
windows (the bucketed layout's), and full rows; for intersect's
final-run rule also rows whose final run is long and not the sentinel,
rows of one value, all-sentinel rows, ``a`` below ``b[0]``, M of 2, 3
and 5, and a live prefix longer than the kernel's 4,096-id shared-memory
stage.  Values stay inside (INT32_MIN, INT32_MAX), which the Pallas
wrapper pads with.  Free of JAX, so the card-only tests can run where
JAX is not installed."""
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
