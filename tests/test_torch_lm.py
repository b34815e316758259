"""The port's LM serving path against the reference: reduced OLMoE (MoE,
qk-norm) and reduced Qwen3-4B (GQA 8/2, qk-norm, tied embeddings), with
the reference's parameters from ``init_lm_params(PRNGKey(0))`` carried
across by ``lm_params_from_arrays``.  ``lm_forward`` logits, ``prefill``
logits and cache, and three ``decode_step``s are held to a relative 1e-4
in float32 and 5e-2 in bfloat16 (max |port - reference| over max
|reference|).  An MLA or MTP config trains; an unknown arch raises."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models.transformer import decode_step as jax_decode
from repro.models.transformer import init_lm_params as jax_init
from repro.models.transformer import lm_forward as jax_forward
from repro.models.transformer import prefill as jax_prefill

from repro_torch.configs import MLAConfig, get_config, get_reduced
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import (decode_step, init_lm_params, lm_forward,
                                lm_loss, prefill)

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S, MAX_LEN, STEPS = 2, 12, 16, 3


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-4b"])
def test_serving_matches_reference(arch, dtype):
    jcfg = dataclasses.replace(jax_reduced(arch), dtype=dtype)
    cfg = dataclasses.replace(get_reduced(arch), dtype=dtype)
    params = jax_init(jax.random.PRNGKey(0), jcfg)
    model = lm_params_from_arrays(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    tt = torch.from_numpy(tokens)
    tol = TOL[dtype]

    want, _, _ = jax.jit(lambda p, t: jax_forward(p, jcfg, t))(
        params, jnp.asarray(tokens))
    got, _, _ = lm_forward(model, tt)
    assert _rel(got, want) <= tol

    want, jcache = jax.jit(lambda p, t: jax_prefill(p, jcfg, t,
                                                    max_len=MAX_LEN))(
        params, jnp.asarray(tokens))
    got, cache = prefill(model, tt, max_len=MAX_LEN)
    assert _rel(got, want) <= tol
    for k in ("k", "v"):
        assert cache[k].shape == jcache[k].shape
        assert _rel(cache[k], jcache[k]) <= tol

    step = jax.jit(lambda p, c, t, n: jax_decode(p, jcfg, c, t, n))
    nxt = tokens[:, -1]
    for i in range(STEPS):
        want, jcache = step(params, jcache, jnp.asarray(nxt),
                            jnp.int32(S + i))
        got, cache = decode_step(model, cache, torch.from_numpy(nxt), S + i)
        assert got.shape == (B, cfg.vocab)
        assert _rel(got, want) <= tol
        for k in ("k", "v"):
            assert _rel(cache[k], jcache[k]) <= tol
        nxt = np.asarray(want, np.float32).argmax(-1)


def test_prefill_last_only_is_the_last_row():
    cfg = dataclasses.replace(get_reduced("qwen3-4b"), dtype="float32")
    model = init_lm_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    tokens = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(1))
    full, _ = prefill(model, tokens)
    last, _ = prefill(model, tokens, last_only=True)
    assert last.shape == (B, 1, cfg.vocab)
    torch.testing.assert_close(last, full[:, -1:], rtol=1e-6, atol=1e-6)


def test_init_follows_reference_scales():
    """Stacked expert weights (E, d, f) are scaled by 1/sqrt(E), as the
    reference's ``_init`` does, not by the fan-in."""
    cfg = dataclasses.replace(get_reduced("olmoe-1b-7b"), dtype="float32")
    model = init_lm_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    wg = model.blocks[0].ffn["wg"]
    assert wg.shape == (cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert)
    np.testing.assert_allclose(float(wg.std()), cfg.moe.n_experts ** -0.5,
                               rtol=0.05)
    np.testing.assert_allclose(float(model.embed.std()), 0.02, rtol=0.05)
    assert not any(p.requires_grad for p in model.parameters())


def test_mla_and_mtp_configs_train():
    """An MLA or MTP config trains: ``lm_loss`` is finite and its
    gradient reaches every parameter but the aux-free router's bias (its
    selection only; the reference's gradient there is zero)."""
    tokens = torch.randint(0, 64, (1, 6),
                           generator=torch.Generator().manual_seed(0))
    for cfg in (dataclasses.replace(get_reduced("qwen3-4b"), mla=MLAConfig(
                    q_lora_rank=16, kv_lora_rank=8, qk_nope_head_dim=8,
                    qk_rope_head_dim=4, v_head_dim=8)),
                dataclasses.replace(get_reduced("qwen3-4b"), mtp_depth=1),
                get_reduced("deepseek-v3-671b")):
        cfg = dataclasses.replace(cfg, dtype="float32")
        model = init_lm_params(torch.Generator().manual_seed(1), cfg,
                               device="cpu").requires_grad_(True)
        loss = lm_loss(model, tokens, tokens)
        assert bool(torch.isfinite(loss))
        loss.backward()
        for name, p in model.named_parameters():
            assert (p.grad is None) == name.endswith("router_bias"), name


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_decode_step_on_full_cache_raises():
    """A step at ``length == max_len`` raises ``ValueError`` naming both
    and writes no cache slot.  (The reference clamps the write through
    ``dynamic_update_slice`` and overwrites the last slot.)"""
    cfg = dataclasses.replace(get_reduced("qwen3-4b"), dtype="float32")
    model = init_lm_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    tokens = torch.randint(0, cfg.vocab, (B, 8),
                           generator=torch.Generator().manual_seed(1))
    logits, cache = prefill(model, tokens, max_len=8)
    before = {k: v.clone() for k, v in cache.items()}
    with pytest.raises(ValueError, match=r"length = 8.*max_len = 8"):
        decode_step(model, cache, logits[:, -1].argmax(-1), 8)
    for k in cache:
        assert torch.equal(cache[k], before[k]), k
    logits, _ = decode_step(model, cache, logits[:, -1].argmax(-1), 7)
    assert bool(torch.isfinite(logits).all())
