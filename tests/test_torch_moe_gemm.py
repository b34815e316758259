"""The port's moe_gemm module and MoE block: the kernel's plain PyTorch
version (the wrapper on a CPU tensor) against the reference's Pallas
kernel in interpret mode at the reference's sweep shapes, and
``moe_block`` against the reference's on the reduced OLMoE config in
float32 — the selected experts, the capacity mask, the aux loss and the
output — with and without dropped tokens.  The CUDA kernel is held
against the plain version on the card in ``test_torch_gpu.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.distributed import ctx as jax_ctx
from repro.kernels.moe_gemm.kernel import moe_gemm_pallas
from repro.models.layers import init_moe_params as jax_init_moe
from repro.models.layers import moe_block as jax_moe_block

from _lm_cases import MOE_SWEEP, MOE_TOL, moe_inputs
from repro_torch.configs import get_reduced
from repro_torch.convert import tensor_from_array
from repro_torch.distributed import ctx
from repro_torch.kernels.moe_gemm import ops
from repro_torch.kernels.moe_gemm.ref import (bound_ratio, moe_down_ref,
                                              moe_gemm_f64, moe_gemm_ref,
                                              moe_hidden_ref)
from repro_torch.models import layers

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CPU = torch.device("cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f", MOE_SWEEP)
def test_plain_matches_pallas_sweep(E, C, d, f, dtype):
    jdt, tdt = DTYPES[dtype]
    arrays = moe_inputs(E, C, d, f, seed=E * C)
    want = moe_gemm_pallas(*(jnp.asarray(a, jdt) for a in arrays),
                           bc=32, bf=32, interpret=True)
    got = ops.moe_gemm(*(torch.from_numpy(a).to(tdt) for a in arrays))
    assert got.dtype == tdt and got.shape == (E, C, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=MOE_TOL[dtype], atol=MOE_TOL[dtype])


def _keep_oracle(sel: np.ndarray, E: int, C: int) -> np.ndarray:
    """Capacity mask by counting, pair by pair in token order: a pair is
    kept while its expert has fewer than C earlier pairs."""
    seen = np.zeros(E, np.int64)
    keep = np.zeros(sel.size, bool)
    for i, e in enumerate(sel.reshape(-1)):
        keep[i] = seen[e] < C
        seen[e] += 1
    return keep


@pytest.mark.parametrize("variant", ["olmoe", "dropped", "aux_free_shared"])
def test_moe_block_matches_reference(variant):
    cfg = dataclasses.replace(get_reduced("olmoe-1b-7b"), dtype="float32")
    jcfg = dataclasses.replace(jax_reduced("olmoe-1b-7b"), dtype="float32")
    if variant == "aux_free_shared":
        over = dict(router_aux_free=True, n_shared=1)
        cfg = dataclasses.replace(cfg,
                                  moe=dataclasses.replace(cfg.moe, **over))
        jcfg = dataclasses.replace(jcfg,
                                   moe=dataclasses.replace(jcfg.moe, **over))
    cf = 0.5 if variant == "dropped" else None
    jp = jax_init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32)
    if variant == "aux_free_shared":   # a bias that changes the selection
        jp["router_bias"] = jnp.asarray(
            np.random.default_rng(1).normal(0, 0.05, jcfg.moe.n_experts),
            jnp.float32)
    p = {k: tensor_from_array(np.asarray(v), CPU) for k, v in jp.items()}
    x = np.random.default_rng(2).standard_normal((2, 12, cfg.d_model),
                                                 dtype=np.float32)
    jax_ctx.set_flags(moe_capacity_factor=cf)
    ctx.set_flags(moe_capacity_factor=cf)
    try:
        want_y, want_aux = jax_moe_block(jp, jcfg, jnp.asarray(x))
        got_y, got_aux = layers.moe_block(p, cfg, torch.from_numpy(x))
    finally:
        jax_ctx.reset()
        ctx.reset()

    xt = x.reshape(-1, cfg.d_model)
    mo = cfg.moe
    logits = jnp.asarray(xt) @ jp["router"]
    if mo.router_aux_free:
        want_sel = jax.lax.top_k(jax.nn.sigmoid(logits) + jp["router_bias"],
                                 mo.top_k)[1]
    else:
        want_sel = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), mo.top_k)[1]
    sel, _, _ = layers.moe_route(p, cfg, torch.from_numpy(xt))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want_sel))
    T = xt.shape[0]
    C = max(int(T * mo.top_k / mo.n_experts * (cf or mo.capacity_factor)), 1)
    _, _, keep = layers.moe_slots(sel.reshape(-1), C)
    want_keep = _keep_oracle(np.asarray(want_sel), mo.n_experts, C)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert want_keep.all() == (variant != "dropped")
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-5)


def test_ctx_flags():
    """The flags ``moe_block`` reads: set, reset, an unknown name raises,
    and ``constrain`` is the identity on one card."""
    x = torch.ones(3)
    try:
        ctx.set_flags(moe_capacity_factor=2.0, moe_tp=True)
        assert ctx.CURRENT.moe_capacity_factor == 2.0 and ctx.CURRENT.moe_tp
        with pytest.raises(AttributeError):
            ctx.set_flags(no_such_flag=1)
        assert ctx.constrain(x, "model", None) is x
    finally:
        ctx.reset()
    assert ctx.CURRENT.moe_capacity_factor is None and not ctx.CURRENT.moe_tp


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros((2, 4, 8))
    wg = torch.zeros((2, 8, 16))
    wd = torch.zeros((2, 16, 8))
    with pytest.raises(TypeError):
        ops.moe_gemm(x.double(), wg.double(), wg.double(), wd.double())
    with pytest.raises(TypeError):
        ops.moe_gemm(x, wg.bfloat16(), wg, wd)
    with pytest.raises(ValueError):
        ops.moe_gemm(x, wg, wg, wd[:, :8])                # wd not (E, f, d)
    with pytest.raises(ValueError):
        ops.moe_gemm(x[0], wg, wg, wd)                    # rank 2


def test_cpu_path_launches_nothing():
    before = ops.launches
    by_variant = dict(ops.launches_by_variant)
    ops.moe_gemm(*(torch.from_numpy(a) for a in moe_inputs(2, 4, 8, 16)))
    assert ops.launches == before
    assert ops.launches_by_variant == by_variant


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,C,d,f,ptrs,want", [
    (BF16, 2560, 2048, 1024, (0x1000, 0x2000), "wgmma"),  # OLMoE prefill
    (BF16, 5120, 2048, 1024, (), "wgmma"),                # prefill_32k
    (BF16, 9, 2048, 1024, (), "wgmma"),       # the first C past decode
    (BF16, 8, 2048, 1024, (), "stream"),      # the last decode C
    (BF16, 1, 2048, 1024, (), "stream"),      # OLMoE decode
    (BF16, 5, 48, 40, (), "stream"),
    (BF16, 1, 37, 41, (0x1002,), "stream"),   # any width and alignment
    (BF16, 37, 48, 40, (), "wgmma"),          # ragged tiles
    (BF16, 37, 36, 40, (), "simt"),           # d % 8 != 0
    (BF16, 37, 48, 44, (), "simt"),           # f % 8 != 0
    (BF16, 64, 2048, 1024, (0x1000, 0x1008), "simt"),   # misaligned
    (F32, 1, 2048, 1024, (), "simt"),         # f32 stays on the CUDA cores
    (F32, 2560, 2048, 1024, (), "simt"),
])
def test_route(dtype, C, d, f, ptrs, want):
    assert ops.route(dtype, C, d, f, ptrs) == want
    assert want in ops.VARIANTS
    assert set(ops.launches_by_variant) == set(ops.VARIANTS)


@pytest.mark.parametrize("E,C,d,f", [*MOE_SWEEP, (5, 37, 48, 40),
                                     (2, 9, 2048, 1024)])
def test_f64_bounds_hold_the_plain_version(E, C, d, f):
    """``moe_gemm_f64``'s bounds, which the card's checks hold the kernel
    to in bf16: the plain version's run lies within them (h within one
    rounding of the exact h, the output within its bound), an h one bf16
    step off does not, nor does a run with gate and up swapped."""
    x, wg, wu, wd = (torch.from_numpy(a).to(BF16)
                     for a in moe_inputs(E, C, d, f, seed=E * C))
    exact = moe_gemm_f64(x, wg, wu, wd)
    assert exact["out"].dtype == torch.float64
    h = moe_hidden_ref(x, wg, wu)
    assert bound_ratio(h, exact["h"], exact["h_bound"]) <= 1
    assert bound_ratio(moe_down_ref(h, wd), exact["out"],
                       exact["out_bound"]) <= 1
    off = (h.float() * (1 + 2 ** -7)).to(BF16)
    assert bound_ratio(off, exact["h"], exact["h_bound"]) > 1
    assert bound_ratio(moe_gemm_ref(x, wu, wg, wd), exact["out"],
                       exact["out_bound"]) > 1
