"""The port's DeepSeek-V3 serving path against the reference on the CPU:
reduced ``deepseek-v3-671b`` (one dense and one MoE layer, MLA, the
aux-free sigmoid router with its ``router_bias``, a shared expert and the
MTP head), the reference's parameters from ``init_lm_params(PRNGKey(0))``
carried across by ``lm_params_from_arrays``.  ``lm_forward`` logits,
``prefill`` logits and both MLA cache keys, and three ``decode_step``s
each naive and absorbed are held to a relative 1e-4 in float32 and 5e-2
in bfloat16 (max |port - reference| over max |reference|); each MLA
function alone to 1e-5 in float32; and the parameter tree, ``mtp``
included, round-trips through the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import layers as jax_layers
from repro.models.transformer import decode_step as jax_decode
from repro.models.transformer import init_lm_params as jax_init
from repro.models.transformer import lm_forward as jax_forward
from repro.models.transformer import prefill as jax_prefill

from repro_torch.configs import get_reduced
from repro_torch.convert import (lm_arrays_from_model, lm_params_from_arrays,
                                 tensor_from_array)
from repro_torch.models import (cache_spec, decode_step, init_lm_params,
                                layers, lm_forward, prefill)

torch.set_num_threads(1)

ARCH = "deepseek-v3-671b"
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S, MAX_LEN, STEPS = 2, 12, 16, 3


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _configs(dtype: str):
    return (dataclasses.replace(jax_reduced(ARCH), dtype=dtype),
            dataclasses.replace(get_reduced(ARCH), dtype=dtype))


def test_reduced_config_exercises_the_slice():
    """The reduced config keeps what the full one runs: MLA with D != Dv,
    a dense prefix, aux-free routing, a shared expert and the MTP head;
    the cache is MLA's latent one."""
    cfg = get_reduced(ARCH)
    m = cfg.mla
    assert m.qk_nope_head_dim + m.qk_rope_head_dim != m.v_head_dim
    assert cfg.moe.first_k_dense == 1 and cfg.n_layers == 2
    assert cfg.moe.router_aux_free and cfg.moe.n_shared == 1
    assert cfg.mtp_depth == 1
    spec = cache_spec(cfg, B, MAX_LEN)
    assert spec.kind == "mla"
    assert {k: s for k, (s, _) in spec.shapes.items()} == {
        "c_kv": (2, B, MAX_LEN, m.kv_lora_rank),
        "k_rope": (2, B, MAX_LEN, m.qk_rope_head_dim)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_matches_reference(dtype):
    jcfg, cfg = _configs(dtype)
    params = jax_init(jax.random.PRNGKey(0), jcfg)
    # a nonzero router bias, so the aux-free selection differs from the
    # gates' order
    bias = np.random.default_rng(2).normal(
        0, 0.5, params["moe_stack"]["ffn"]["router_bias"].shape)
    params["moe_stack"]["ffn"]["router_bias"] = jnp.asarray(bias,
                                                            jnp.float32)
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
    assert set(cache) == set(jcache) == {"c_kv", "k_rope"}
    for k in cache:
        assert cache[k].shape == jcache[k].shape
        assert _rel(cache[k], jcache[k]) <= tol

    for absorbed in (False, True):
        step = jax.jit(lambda p, c, t, n: jax_decode(p, jcfg, c, t, n,
                                                     absorbed=absorbed))
        jc = dict(jcache)
        pc = {k: v.clone() for k, v in cache.items()}
        nxt = tokens[:, -1]
        for i in range(STEPS):
            want, jc = step(params, jc, jnp.asarray(nxt), jnp.int32(S + i))
            got, pc = decode_step(model, pc, torch.from_numpy(nxt), S + i,
                                  absorbed=absorbed)
            assert got.shape == (B, cfg.vocab)
            assert _rel(got, want) <= tol, (absorbed, i)
            for k in pc:
                assert _rel(pc[k], jc[k]) <= tol, (absorbed, i, k)
            nxt = np.asarray(want, np.float32).argmax(-1)


def _mla_inputs(cfg, rng):
    m = cfg.mla
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    positions = np.arange(S)[None, :]
    c_kv = rng.standard_normal((B, S, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, S, 1, m.qk_rope_head_dim)).astype(
        np.float32)
    return x, positions, c_kv, kr


def test_mla_functions_match_reference():
    """Each MLA function on the same f32 inputs; the absorbed decode at a
    per-row ``length``."""
    jcfg, cfg = _configs("float32")
    jp = jax_layers.init_mla_params(jax.random.PRNGKey(3), jcfg, jnp.float32)
    p = {k: tensor_from_array(np.asarray(v), torch.device("cpu"))
         for k, v in jp.items()}
    x, positions, c_kv, kr = _mla_inputs(cfg, np.random.default_rng(4))
    tx, tpos, tc, tkr = (torch.from_numpy(a) for a in
                         (x, positions, c_kv, kr))

    def held(got, want, tol=1e-5):
        assert _rel(got, want) <= tol

    for got, want in zip(layers.mla_compress(p, cfg, tx, tpos),
                         jax_layers.mla_compress(jp, jcfg, x, positions)):
        held(got, want)
    for got, want in zip(layers.mla_queries(p, cfg, tx, tpos),
                         jax_layers.mla_queries(jp, jcfg, x, positions)):
        held(got, want)
    for got, want in zip(layers.mla_expand_kv(p, cfg, tc),
                         jax_layers.mla_expand_kv(jp, jcfg, c_kv)):
        held(got, want)
    length = np.array([S - 3, S], np.int32)
    pos1 = length[:, None] - 1
    got = layers.mla_absorbed_decode(p, cfg, tx[:, :1], tc, tkr,
                                     torch.from_numpy(length),
                                     torch.from_numpy(pos1))
    want = jax_layers.mla_absorbed_decode(jp, jcfg, x[:, :1], c_kv, kr,
                                          length, pos1)
    assert got.shape == (B, 1, cfg.d_model)
    held(got, want)


def test_tree_round_trips_with_mtp():
    """The reference's tree, ``mtp`` included, through the port's model and
    back, leaf for leaf; and a model the port draws has the reference's
    tree structure and shapes."""
    jcfg, cfg = _configs("float32")
    tree = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jcfg))
    model = lm_params_from_arrays(tree, cfg, device="cpu")
    assert model.mtp is not None and not model.mtp.block.moe
    back = lm_arrays_from_model(model)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    drawn = lm_arrays_from_model(init_lm_params(torch.Generator(), cfg,
                                                device="cpu"))
    assert (jax.tree_util.tree_structure(drawn)
            == jax.tree_util.tree_structure(tree))
    assert ([a.shape for a in jax.tree.leaves(drawn)]
            == [a.shape for a in jax.tree.leaves(tree)])
