"""Inputs of the intersect and delta_vlen kernel tests, made with numpy
from fixed seeds: the reference's kernel sweep shapes, sentinel-padded
windows (the bucketed layout's), and full rows.  Free of JAX, so the
card-only tests can run where JAX is not installed."""
import numpy as np

INTERSECT_SWEEP = [(5, 20), (33, 129), (128, 64), (17, 8), (40, 65), (9, 200)]
INTERSECT_CASES = ([("sweep", s) for s in INTERSECT_SWEEP]
                   + [("padded", s) for s in ((64, 37), (300, 16), (7, 1))])
DELTA_VLEN_SWEEP = [(3, 16), (7, 130), (260, 64), (1, 300)]


def intersect_inputs(kind, B, M):
    """Sorted rows ``a``, ``b`` (B, M) and the sentinel: the reference
    sweep's draws (``test_intersect_sweep``), or sentinel-padded windows
    of random degree."""
    rng = np.random.default_rng(B + M)      # as tests/test_kernels.py
    sent = 500
    a = np.sort(rng.integers(0, sent, (B, M)).astype(np.int32), axis=1)
    b = np.sort(rng.integers(0, sent, (B, M)).astype(np.int32), axis=1)
    if kind == "padded":
        col = np.arange(M)
        a = np.where(col < rng.integers(0, M + 1, (B, 1)), a, sent)
        b = np.where(col < rng.integers(0, M + 1, (B, 1)), b, sent)
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
