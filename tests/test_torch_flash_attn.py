"""The port's flash-attention module: its plain PyTorch version (the
kernel wrapper on a CPU tensor) against the reference's Pallas kernel in
interpret mode at the reference's sweep shapes, and the model-level
``layers.flash_attention`` against the reference model's chunked online
softmax (GQA, ``q_offset``, lengths that are not a multiple of the
chunk).  The CUDA kernel is held against the plain version on the card
in ``test_torch_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.ops import flash_attention_k as jax_flash_k
from repro.models.layers import flash_attention as jax_model_flash

from _lm_cases import FLASH_SWEEP, FLASH_TOL, flash_inputs
from repro_torch.kernels.flash_attn import ops
from repro_torch.models import layers

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,Hk,D", FLASH_SWEEP)
def test_plain_matches_pallas_sweep(S, H, Hk, D, dtype):
    (jq, jk, jv), (q, k, v) = _both(
        flash_inputs(2, S, S, H, Hk, D, seed=S + H), dtype)
    want = jax_flash_k(jq, jk, jv, causal=True, use_kernel=True,
                       interpret=True, bq=32, bk=32)
    got = ops.flash_attention_k(q, k, v, causal=True)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (2, S, H, D)
    _close(got, want, FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_mla_widths(causal, dtype):
    """D != Dv: the reduced DeepSeek-V3's MLA head (D = 16 + 8, Dv = 16),
    GQA 4/2; the output takes v's width."""
    (jq, jk, jv), (q, k, v) = _both(
        flash_inputs(2, 64, 64, 4, 2, 24, seed=11, Dv=16), dtype)
    want = jax_flash_k(jq, jk, jv, causal=causal, use_kernel=True,
                       interpret=True, bq=32, bk=32)
    got = ops.flash_attention_k(q, k, v, causal=causal)
    assert got.shape == (2, 64, 4, 16)
    _close(got, want, FLASH_TOL[dtype])


def test_plain_matches_pallas_non_causal():
    (jq, jk, jv), (q, k, v) = _both(flash_inputs(2, 64, 96, 4, 1, 32, seed=7),
                                    "float32")
    want = jax_flash_k(jq, jk, jv, causal=False, use_kernel=True,
                       interpret=True, bq=32, bk=32)
    _close(ops.flash_attention_k(q, k, v, causal=False), want,
           FLASH_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,H,Hk,causal,q_offset", [
    (40, 40, 4, 2, True, 0),       # GQA 4/2, 40 = 2.5 chunks of 16
    (24, 40, 4, 1, True, 16),      # the last 24 queries of 40 positions
    (37, 53, 4, 4, False, 0),      # non-causal, ragged in both lengths
])
def test_model_flash_matches_reference(Sq, Skv, H, Hk, causal, q_offset,
                                       dtype):
    (jq, jk, jv), (q, k, v) = _both(
        flash_inputs(2, Sq, Skv, H, Hk, 16, seed=Sq + Skv), dtype)
    want = jax_model_flash(jq, jk, jv, causal=causal, q_chunk=16,
                           kv_chunk=16, q_offset=q_offset)
    got = layers.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    _close(got, want, FLASH_TOL[dtype])
    # the kernel's plain version agrees with the model's chunked path
    plain = ops.flash_attention_k(q, k, v, causal=causal, q_offset=q_offset)
    _close(plain, np.asarray(want, np.float32), FLASH_TOL[dtype])


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(TypeError):
        ops.flash_attention_k(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(TypeError):
        ops.flash_attention_k(q.double(), k.double(), k.double())
    with pytest.raises(ValueError):
        ops.flash_attention_k(q, torch.zeros((1, 8, 3, 16)),
                              torch.zeros((1, 8, 3, 16)))   # H % Hk != 0
    with pytest.raises(ValueError):
        ops.flash_attention_k(q[0], k[0], k[0])             # rank 3
    with pytest.raises(ValueError):
        ops.flash_attention_k(q, k[:, :0], k[:, :0])        # no keys
    with pytest.raises(ValueError):
        ops.flash_attention_k(q, k, k, q_offset=-1)


def test_cpu_path_launches_nothing():
    before = ops.launches
    by_variant = dict(ops.launches_by_variant)
    q, k, v = (torch.from_numpy(a) for a in flash_inputs(1, 8, 8, 2, 2, 8))
    ops.flash_attention_k(q, k, v)
    layers.flash_attention(q, k, v)
    assert ops.launches == before
    assert ops.launches_by_variant == by_variant


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,D,ptrs,want", [
    (BF16, 128, (0x1000, 0x2000, 0x3000, 0x4000), "wgmma"),  # OLMoE, Qwen3
    (BF16, 64, (), "wgmma"),          # qwen1.5's head
    (BF16, 16, (), "wgmma"),          # one k16 step, padded to a panel
    (BF16, 80, (), "wgmma"),          # two panels, the second padded
    (BF16, 72, (), "simt"),           # D % 16 != 0
    (BF16, 8, (), "simt"),
    (BF16, 144, (), "simt"),          # Dv = D > 128
    (BF16, 128, (0x1000, 0x1008), "simt"),   # an 8-byte-aligned pointer
    (F32, 128, (), "simt"),           # f32 stays on the CUDA cores
    (F32, 64, (0x1000,), "simt"),
])
def test_route(dtype, D, ptrs, want):
    assert ops.route(dtype, D, ptrs) == want
    assert want in ops.VARIANTS
    assert set(ops.launches_by_variant) == set(ops.VARIANTS)


@pytest.mark.parametrize("dtype,D,Dv,want", [
    (BF16, 192, 128, "wgmma"),        # DeepSeek-V3's MLA: 3 + 2 panels
    (BF16, 176, 112, "wgmma"),        # padded to (192, 128)
    (BF16, 64, 128, "wgmma"),         # padded to (128, 128)
    (BF16, 128, 64, "wgmma"),
    (BF16, 24, 16, "simt"),           # the reduced MLA head: D % 16 != 0
    (BF16, 208, 128, "simt"),         # D > 192
    (BF16, 192, 144, "simt"),         # Dv > 128
    (BF16, 192, 120, "simt"),         # Dv % 16 != 0
    (F32, 192, 128, "simt"),
])
def test_route_with_v_width(dtype, D, Dv, want):
    assert ops.route(dtype, D, (0x1000, 0x2000), Dv) == want


def _flash_wgmma_rounding(q, k, v, causal, q_offset=0, bk=128):
    """A PyTorch model of the wgmma variant's arithmetic on (B·H, S, D)
    tensors: 128-key tiles in order, scores in f32 scaled after the
    product into the log2 domain, an online softmax in f32, and P rounded
    to bf16 before P·V (the row sums stay in f32)."""
    D = q.shape[-1]
    qf, kf, vf = q.float(), k.float(), v.float()
    BH, Sq, Skv = q.shape[0], q.shape[1], k.shape[1]
    m = torch.full((BH, Sq, 1), -torch.inf)
    l = torch.zeros((BH, Sq, 1))
    acc = torch.zeros((BH, Sq, D))
    qpos = torch.arange(Sq)[:, None] + q_offset
    for k0 in range(0, Skv, bk):
        s = torch.einsum("bqd,bkd->bqk", qf, kf[:, k0:k0 + bk])
        s = s * (D ** -0.5 * 1.4426950408889634)
        if causal:
            key = torch.arange(k0, min(k0 + bk, Skv))[None, :]
            s = s.masked_fill(~(qpos >= key)[None], -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum(
            "bqk,bkd->bqd", p.bfloat16().float(), vf[:, k0:k0 + bk])
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


@pytest.mark.parametrize("S,H,Hk,D,causal", [
    *[(S, H, Hk, D, True) for S, H, Hk, D in FLASH_SWEEP],
    (320, 2, 2, 64, True),      # three 128-key tiles, the last ragged
    (320, 2, 1, 32, False)])
def test_wgmma_rounding_is_inside_the_bf16_tolerance(S, H, Hk, D, causal):
    """The wgmma variant moves two rounding points (P in bf16, the scale
    after the product): a model of them stays inside 2e-2 of the Pallas
    kernel in interpret mode."""
    (jq, jk, jv), (q, k, v) = _both(flash_inputs(1, S, S, H, Hk, D, seed=S),
                                    "bfloat16")
    want = jax_flash_k(jq, jk, jv, causal=causal, use_kernel=True,
                       interpret=True, bq=32, bk=32)
    rep = H // Hk
    qf = q.transpose(1, 2).reshape(H, S, D)
    kf, vf = (t.repeat_interleave(rep, dim=2).transpose(1, 2).reshape(H, S, D)
              for t in (k, v))
    got = _flash_wgmma_rounding(qf, kf, vf, causal)
    got = got.reshape(1, H, S, D).transpose(1, 2)
    _close(got, want, FLASH_TOL["bfloat16"])
