"""Inputs of the membership kernel tests, made with numpy from fixed
seeds: the reference's kernel sweep shapes and the edge cases (full rows
without a sentinel, sentinel queries, M = 1, B not a block multiple).
Free of JAX, so the card-only tests can run where JAX is not installed."""
import numpy as np

SWEEP = [(7, 16, 3), (64, 130, 9), (256, 64, 1), (3, 257, 17)]


def sweep_inputs(B, M, K):
    rng = np.random.default_rng(B * M + K)     # as tests/test_kernels.py
    rows = np.sort(rng.integers(0, 300, (B, M)).astype(np.int32), axis=1)
    vals = rng.integers(0, 300, (B, K)).astype(np.int32)
    return rows, vals


def edge_inputs(case):
    rng = np.random.default_rng(7)
    sent = 1000
    if case == "full_rows_no_sentinel":
        rows = np.sort(rng.choice(sent, (40, 30)), axis=1).astype(np.int32)
        vals = rng.integers(-5, sent + 5, (40, 6)).astype(np.int32)
    elif case == "sentinel_queries":
        rows = np.sort(rng.integers(0, sent, (40, 30)), axis=1)
        deg = rng.integers(0, 31, (40, 1))
        rows = np.where(np.arange(30) < deg, rows, sent).astype(np.int32)
        vals = np.full((40, 4), sent, np.int32)
        vals[:, 0] = rows[:, 0]
    elif case == "m_is_1":
        rows = rng.integers(0, 4, (33, 1)).astype(np.int32)
        vals = rng.integers(0, 5, (33, 3)).astype(np.int32)
    else:                                        # B not a block multiple
        rows = np.sort(rng.integers(0, 100, (257, 33)), axis=1)
        rows = rows.astype(np.int32)
        vals = rng.integers(0, 101, (257, 3)).astype(np.int32)
    return rows, vals


CASES = ([("sweep", s) for s in SWEEP]
         + [("edge", c) for c in ("full_rows_no_sentinel", "sentinel_queries",
                                  "m_is_1", "b_not_block_multiple")])
