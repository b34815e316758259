"""The plain backward of the port's two LM kernels, which the card holds
its backward kernels against (``chip_smoke.py`` phase 12,
``test_torch_gpu.py``): ``flash_attention_bwd_ref`` against ``jax.grad``
of the reference's model attention (``repro.models.layers
.flash_attention``, chunked online softmax) and ``moe_gemm_bwd_ref``
against ``jax.grad`` of the reference's ``moe_gemm_ref``, both in float32
at a relative 1e-5 (max |port - reference| over max |reference|), and
both against float64 autograd of the plain forward at 1e-12.  Cases:
GQA, causal and not, lengths off the chunk size, and a query offset.
The autograd Functions (``FlashAttention``, ``MoeGemm``) run the same
plain backward on a CPU tensor.  Card-only (``gpu``, skipped without a
card): flash_attn's three backward kernels at MLA's head widths, D = 192
and Dv = 128 (and the reduced config's 24 and 16), against the plain
backward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gemm.ref import moe_gemm_ref as jax_moe_ref
from repro.models.layers import flash_attention as jax_flash

from _lm_cases import flash_inputs, moe_inputs
from repro_torch.kernels.flash_attn import ops as flash
from repro_torch.kernels.flash_attn.ref import flash_attention_bwd_ref
from repro_torch.kernels.moe_gemm import ops as moe
from repro_torch.kernels.moe_gemm.ref import (moe_bwd_hidden_ref,
                                              moe_gemm_bwd_ref, moe_gemm_ref)

torch.set_num_threads(1)

JAX_TOL = 1e-5      # float32 against float32, sums in another order
F64_TOL = 1e-12     # float64 against float64

# (B, Sq, Skv, H, Hk, D, causal, q_offset)
FLASH_CASES = [
    (2, 40, 40, 4, 2, 16, True, 0),      # GQA 4/2, 40 = 2.5 chunks of 16
    (1, 24, 40, 4, 1, 16, True, 16),     # the last 24 queries of 40
    (2, 37, 53, 4, 4, 8, False, 0),      # non-causal, ragged
]


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(got.double().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-300))


def _naive_attention(q, k, v, causal, q_offset):
    """Softmax attention in the model's layout, any dtype, for autograd."""
    rep = q.shape[2] // k.shape[2]
    kr, vr = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) * q.shape[-1] ** -0.5
    if causal:
        keep = ((torch.arange(q.shape[1])[:, None] + q_offset)
                >= torch.arange(k.shape[1])[None, :])
        s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vr)


@pytest.fixture(scope="module")
def flash_want():
    """jax.grad of the reference's attention, once per case."""
    out = {}
    for case in FLASH_CASES:
        B, Sq, Skv, H, Hk, D, causal, off = case
        q, k, v = flash_inputs(B, Sq, Skv, H, Hk, D, seed=Sq + Skv)
        do = np.random.default_rng(Sq).standard_normal(
            (B, Sq, H, D), dtype=np.float32)

        def f(q, k, v):
            o = jax_flash(q, k, v, causal=causal, q_chunk=16, kv_chunk=16,
                          q_offset=off)
            return jnp.sum(o * do)

        grads = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
        out[case] = ((q, k, v, do), [np.asarray(g) for g in grads])
    return out


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bwd_ref_matches_reference_grad(case, flash_want):
    (q, k, v, do), want = flash_want[case]
    causal, off = case[6], case[7]
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash.flash_attention_plain(q, k, v, causal, off,
                                         return_lse=True)
    got = flash_attention_bwd_ref(q, k, v, o, lse, do, causal, off)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g, w) <= JAX_TOL
    # the Function on a CPU tensor: plain forward, plain backward
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash.flash_attention_ad(*leaves, causal=causal, q_offset=off)
    assert torch.equal(out.detach(), o)
    out.backward(do)
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bwd_ref_matches_float64_autograd(case):
    B, Sq, Skv, H, Hk, D, causal, off = case
    q, k, v = (torch.from_numpy(a).double().requires_grad_()
               for a in flash_inputs(B, Sq, Skv, H, Hk, D, seed=1))
    do = torch.randn((B, Sq, H, D), dtype=torch.float64,
                     generator=torch.Generator().manual_seed(2))
    want = torch.autograd.grad(_naive_attention(q, k, v, causal, off),
                               (q, k, v), do)
    q, k, v = q.detach(), k.detach(), v.detach()
    o, lse = flash.flash_attention_plain(q, k, v, causal, off,
                                         return_lse=True)
    assert lse.dtype == torch.float64
    got = flash_attention_bwd_ref(q, k, v, o, lse, do, causal, off,
                                  q_chunk=16)
    for g, w in zip(got, want):
        assert _rel(g, w) <= F64_TOL


def test_flash_bwd_k_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in flash_inputs(1, 8, 8, 4, 2, 16))
    o, lse = flash.flash_attention_plain(q, k, v, return_lse=True)
    with pytest.raises(ValueError):
        flash.flash_attention_bwd_k(q, k, v, o, lse[:, :2], o)   # lse shape
    with pytest.raises(ValueError):
        flash.flash_attention_bwd_k(q, k, v, o, lse.double(), o)
    with pytest.raises(ValueError):
        flash.flash_attention_bwd_k(q, k, v, o, lse, o[:, :4])   # do shape


MOE_CASES = [(4, 64, 32, 64), (3, 37, 48, 40)]


@pytest.mark.parametrize("E,C,d,f", MOE_CASES)
def test_moe_bwd_ref_matches_reference_grad(E, C, d, f):
    x, wg, wu, wd = moe_inputs(E, C, d, f, seed=E + C)
    dy = np.random.default_rng(C).standard_normal((E, C, d),
                                                  dtype=np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_moe_ref(*a) * dy),
                    argnums=(0, 1, 2, 3))(x, wg, wu, wd)
    ins = [torch.from_numpy(a) for a in (x, wg, wu, wd)]
    got = moe_gemm_bwd_ref(*ins, torch.from_numpy(dy))
    for g, w in zip(got, want):
        assert _rel(g, w) <= JAX_TOL
    # the Function on a CPU tensor runs the same plain backward
    leaves = [t.clone().requires_grad_() for t in ins]
    out = moe.moe_gemm_ad(*leaves)
    assert torch.equal(out.detach(), moe_gemm_ref(*ins))
    out.backward(torch.from_numpy(dy))
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


@pytest.mark.parametrize("E,C,d,f", MOE_CASES)
def test_moe_bwd_ref_matches_float64_autograd(E, C, d, f):
    x, wg, wu, wd = (torch.from_numpy(a).double().requires_grad_()
                     for a in moe_inputs(E, C, d, f, seed=3))
    dy = torch.randn((E, C, d), dtype=torch.float64,
                     generator=torch.Generator().manual_seed(4))
    y = (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd
    want = torch.autograd.grad(y, (x, wg, wu, wd), dy)
    got = moe_gemm_bwd_ref(x.detach(), wg.detach(), wu.detach(),
                           wd.detach(), dy)
    for g, w in zip(got, want):
        assert _rel(g, w) <= F64_TOL
    # what the backward kernel writes: h is the forward's hidden layer
    da, db, h = moe_bwd_hidden_ref(x.detach(), wg.detach(), wu.detach(),
                                   wd.detach(), dy)
    a = x.detach() @ wg.detach()
    assert _rel(h, torch.nn.functional.silu(a) * (x.detach()
                                                  @ wu.detach())) <= F64_TOL


def test_moe_bwd_k_rejects_bad_dy():
    x, wg, wu, wd = (torch.from_numpy(a) for a in moe_inputs(2, 8, 16, 32))
    with pytest.raises(ValueError):
        moe.moe_gemm_bwd_k(x, wg, wu, wd, x[:, :4])
    with pytest.raises(ValueError):
        moe.moe_gemm_bwd_k(x, wg, wu, wd, x.bfloat16())


def test_moe_bwd_route():
    """The backward's variant from dtype, shape and alignment alone."""
    assert moe.route_bwd(torch.bfloat16, 2048, 1024) == "wgmma"
    assert moe.route_bwd(torch.bfloat16, 2048, 1024, (0, 16, 32)) == "wgmma"
    assert moe.route_bwd(torch.bfloat16, 2048, 1024, (0, 8)) == "simt"
    assert moe.route_bwd(torch.bfloat16, 36, 1024) == "simt"
    assert moe.route_bwd(torch.bfloat16, 2048, 20) == "simt"
    assert moe.route_bwd(torch.bfloat16, 0, 1024) == "simt"
    assert moe.route_bwd(torch.float32, 2048, 1024) == "simt"


def test_flash_bwd_route():
    """The dkdv and dq kernels' variant from dtype, head widths and
    alignment alone (v's width defaults to q's)."""
    assert flash.route_bwd(torch.bfloat16, 128) == "wgmma"
    assert flash.route_bwd(torch.bfloat16, 64, (0, 32)) == "wgmma"
    assert flash.route_bwd(torch.bfloat16, 64, (0, 8)) == "simt"
    assert flash.route_bwd(torch.bfloat16, 40) == "simt"
    assert flash.route_bwd(torch.bfloat16, 192) == "simt"     # Dv = 192
    assert flash.route_bwd(torch.float32, 128) == "simt"
    # MLA's widths: D <= 192 and Dv <= 128, both multiples of 16
    assert flash.route_bwd(torch.bfloat16, 192, (0, 32), 128) == "wgmma"
    assert flash.route_bwd(torch.bfloat16, 64, (), 128) == "wgmma"
    assert flash.route_bwd(torch.bfloat16, 24, (), 16) == "simt"
    assert flash.route_bwd(torch.bfloat16, 208, (), 128) == "simt"
    assert flash.route_bwd(torch.bfloat16, 192, (), 144) == "simt"
    assert flash.route_bwd(torch.float32, 192, (), 128) == "simt"


# (B, Sq, Skv, H, Hk, D, Dv, causal, q_offset) at MLA's widths
MLA_BWD_CASES = [
    (2, 128, 128, 4, 4, 24, 16, True, 0),       # the reduced config's
    (1, 300, 300, 4, 2, 192, 128, True, 0),     # ragged causal tiles, GQA
    (1, 200, 400, 4, 2, 192, 128, True, 130),   # q_offset past a key tile
    (1, 100, 150, 4, 1, 192, 128, False, 0),    # non-causal, GQA 4/1
    (1, 255, 257, 4, 4, 176, 96, True, 2),      # padded to (192, 128)
    # the "wgmma" schedule's edges: the last CTA's second consumer has no
    # keys (dkdv) and no queries (dq); the diagonal inside a tile; H/Hk =
    # 4; Sq != Skv, causal with the queries at the end, and not causal
    (1, 320, 320, 4, 4, 192, 128, True, 0),
    (1, 160, 256, 4, 4, 192, 128, True, 96),
    (1, 192, 192, 8, 2, 192, 128, True, 0),
    (1, 100, 356, 4, 4, 192, 128, True, 256),
    (1, 130, 390, 4, 2, 192, 128, False, 0),
    # the other two instantiations share it
    (1, 320, 200, 8, 2, 128, 128, True, 64),
    (2, 130, 130, 4, 4, 64, 64, True, 0),
]
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # of max |plain|


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hk,D,Dv,causal,q_offset",
                         MLA_BWD_CASES)
def test_flash_bwd_kernels_at_mla_widths_on_card(cuda, B, Sq, Skv, H, Hk, D,
                                                 Dv, causal, q_offset,
                                                 dtype):
    """"delta", "dkdv" and "dq" at D != Dv (one launch each; "wgmma" in
    bf16 with both widths multiples of 16, else "simt") on the forward
    kernel's own output and lse: dq and dk D wide, dv Dv wide, each
    within BWD_TOL of the plain backward's largest magnitude and bit for
    bit equal to a second call."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(Sq + D)
    q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in
               flash_inputs(B, Sq, Skv, H, Hk, D, seed=Sq, Dv=Dv))
    do = torch.randn((B, Sq, H, Dv), generator=gen).to(cuda, dt)
    o, lse = flash.flash_attention_k(q, k, v, causal=causal,
                                     q_offset=q_offset, return_lse=True)
    variant = ("wgmma" if dtype == "bfloat16" and D % 16 == 0
               and Dv % 16 == 0 else "simt")
    before = dict(flash.bwd_launches)
    before_v = dict(flash.bwd_launches_by_variant)
    got = flash.flash_attention_bwd_k(q, k, v, o, lse, do, causal, q_offset)
    again = flash.flash_attention_bwd_k(q, k, v, o, lse, do, causal,
                                        q_offset)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal, q_offset)
    torch.cuda.synchronize()
    assert all(flash.bwd_launches[n] == before[n] + 2
               for n in flash.BWD_KERNELS)
    assert flash.bwd_launches_by_variant[variant] == before_v[variant] + 4
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, w, width in zip(got, want, (D, D, Dv)):
        assert g.dtype == dt and g.shape == w.shape and g.shape[-1] == width
        err = (g.float() - w.float()).abs().max()
        assert err <= BWD_TOL[dtype] * w.float().abs().max()
