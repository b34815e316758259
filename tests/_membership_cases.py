"""Inputs of the membership kernel tests, made with numpy from fixed
seeds: the reference's kernel sweep shapes and the edge cases (full rows
without a sentinel, sentinel queries, M = 1, B not a block multiple; and
for the kernel's final-run rule: long final runs that are not the
sentinel, rows of one value, all-sentinel rows, queries below the first
id, K of 2, 3 and 5 and K = M, a live prefix longer than the kernel's
4,096-id shared-memory stage).  Values stay inside (INT32_MIN,
INT32_MAX), which the Pallas wrapper pads with.  Free of JAX, so the
card-only tests can run where JAX is not installed."""
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
    elif case == "b_not_block_multiple":
        rows = np.sort(rng.integers(0, 100, (257, 33)), axis=1)
        rows = rows.astype(np.int32)
        vals = rng.integers(0, 101, (257, 3)).astype(np.int32)
    else:
        rows, vals = final_run_inputs(case, rng, sent)
    return rows, vals


def _queries(rng, rows, K, lo, hi):
    """Half of them ids of the row, half uniform in [lo, hi)."""
    pick = rng.integers(0, rows.shape[1], (rows.shape[0], K))
    return np.where(rng.random((rows.shape[0], K)) < 0.5,
                    np.take_along_axis(rows, pick, 1),
                    rng.integers(lo, hi, (rows.shape[0], K)))


def final_run_inputs(case, rng, sent):
    """The cases of the kernel's final-run rule (see the module doc)."""
    B, M, K = 40, 37, 9
    rows = np.sort(rng.integers(0, sent, (B, M)), axis=1)
    if case == "long_final_run":       # the last id repeated, not sentinel
        start = rng.integers(0, M, (B, 1))
        rows = np.where(np.arange(M) >= start, rows[:, -1:], rows)
    elif case == "one_value_rows":
        rows = np.repeat(rng.integers(0, 20, (B, 1)), M, axis=1)
        return rows.astype(np.int32), _queries(rng, rows, K, 0, 20).astype(
            np.int32)
    elif case == "all_sentinel_rows":
        rows = np.full((B, M), sent)
        vals = _queries(rng, rows, K, -3, sent + 3)
        vals[:, 0] = sent
        return rows.astype(np.int32), vals.astype(np.int32)
    elif case == "below_first":        # rows start high, queries below
        rows = rows + 500
        vals = _queries(rng, rows, K, -1000, 600)
        return rows.astype(np.int32), vals.astype(np.int32)
    elif case.startswith("k_is_"):     # sentinel-padded, K not 4-aligned
        K = M if case == "k_is_m" else int(case[5:])
        deg = rng.integers(0, M + 1, (B, 1))
        rows = np.where(np.arange(M) < deg, rows, sent)
    elif case == "long_row_20000":     # card only: L = 19,000 of 20,000
        B, M, K = 3, 20000, 1000
        rows = np.sort(rng.choice(1 << 24, (B, M)), axis=1)
        rows[:, 19000:] = 1 << 24
        return rows.astype(np.int32), _queries(
            rng, rows, K, 0, (1 << 24) + 2).astype(np.int32)
    elif case == "b_is_1":             # card only: one engine-sized window
        B, M, K = 1, 1780, 1780
        rows = np.sort(rng.integers(0, sent, (B, M)), axis=1)
        rows[:, 6:] = sent
    elif case == "int32_extremes":     # card only: the Pallas pad values
        lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
        rows = np.sort(rng.integers(lo, hi, (B, M), endpoint=True), axis=1)
        rows[:5, 0], rows[5:10, -1] = lo, hi
        rows[10:15] = hi
        rows = np.sort(rows, axis=1)
        vals = _queries(rng, rows, K, lo, hi)
        vals[:, 0], vals[:, 1] = lo, hi
        return rows.astype(np.int32), vals.astype(np.int32)
    elif case == "long_live_prefix":   # L > 4,096: searched in global memory
        B, M, K = 3, 4500, 7
        rows = np.sort(rng.choice(1 << 20, (B, M)), axis=1)
        rows[:, 4400:] = 1 << 20
        return rows.astype(np.int32), _queries(
            rng, rows, K, 0, (1 << 20) + 2).astype(np.int32)
    return rows.astype(np.int32), _queries(rng, rows, K, -2,
                                           sent + 2).astype(np.int32)


FINAL_RUN_CASES = ("long_final_run", "one_value_rows", "all_sentinel_rows",
                   "below_first", "k_is_2", "k_is_3", "k_is_5", "k_is_m",
                   "long_live_prefix")
# card only: a row longer than any stage, B = 1, and INT32_MIN/INT32_MAX
CARD_CASES = [("edge", c) for c in ("long_row_20000", "b_is_1",
                                    "int32_extremes")]
CASES = ([("sweep", s) for s in SWEEP]
         + [("edge", c) for c in ("full_rows_no_sentinel", "sentinel_queries",
                                  "m_is_1", "b_not_block_multiple")
            + FINAL_RUN_CASES])
