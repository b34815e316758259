"""Shared inputs of the LM-path kernel tests (flash_attn, moe_gemm): the
sweep shapes of ``tests/test_kernels.py`` and seeded numpy inputs, so the
CPU parity tests and the card-only tests feed both kernels the same
numbers.  Imports no JAX."""
import numpy as np

# (S, H, Hk, D) of test_flash_attention_sweep, run here at batch 2 in
# the model's (B, S, H, D) layout so the GQA broadcast is exercised
FLASH_SWEEP = [(64, 4, 2, 32), (128, 2, 2, 16)]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (E, C, d, f) of test_moe_gemm_sweep
MOE_SWEEP = [(4, 64, 32, 64), (2, 128, 16, 128)]
MOE_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# moe_gemm in float32 at C = 1 (decode) is held per output row, not
# elementwise: the plain version's einsum runs as a GEMV on the card, whose
# sum order differs from the kernel's, and outputs near 0 miss 1e-5
# absolute (chip_smoke.py's lm_kernels phase prints both ratios)
MOE_ROW_CHECK = ("float32", 1)


def flash_inputs(B, Sq, Skv, H, Hk, D, seed=0, Dv=None):
    """q (B, Sq, H, D), k (B, Skv, Hk, D), v (B, Skv, Hk, Dv) float32,
    standard normal; Dv defaults to D."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    k = rng.standard_normal((B, Skv, Hk, D), dtype=np.float32)
    v = rng.standard_normal((B, Skv, Hk, D if Dv is None else Dv),
                            dtype=np.float32)
    return q, k, v


def moe_inputs(E, C, d, f, seed=0):
    """x (E, C, d) standard normal; wg/wu (E, d, f), wd (E, f, d) at 0.1
    of standard normal, as the reference sweep scales them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, d), dtype=np.float32)
    wg = 0.1 * rng.standard_normal((E, d, f), dtype=np.float32)
    wu = 0.1 * rng.standard_normal((E, d, f), dtype=np.float32)
    wd = 0.1 * rng.standard_normal((E, f, d), dtype=np.float32)
    return x, wg, wu, wd
