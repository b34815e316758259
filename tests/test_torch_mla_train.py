"""The port's training path for DeepSeek-V3 (MLA, the aux-free router,
the depth-1 MTP loss) against the reference's, on the CPU.

``lm_loss`` with both cross entropies and every parameter's gradient,
``mtp.*`` and the MLA weights included, against ``jax.value_and_grad`` of
the reference's ``lm_loss`` (without its per-block ``jax.checkpoint``,
which changes no value) on reduced DeepSeek-V3 (one dense and one MoE
layer, a nonzero ``router_bias``) and on reduced Qwen3-4B with an MTP
head (MTP over GQA), in float32, parameters carried over by
``lm_params_from_arrays`` and gradients read back by
``lm_arrays_from_model``: loss within a relative 1e-5, each gradient leaf
within 1e-4 of its largest reference magnitude.  The plain flash_attn
backward at MLA's D != Dv against ``jax.grad`` of the reference's model
attention.  One AdamW step through ``TransformerLM.decayed_params()``
equal to the reference's on every leaf (its stacked tree decays the
per-layer norms and biases).  Five ``Trainer`` steps against the
reference's ``Trainer`` on reduced DeepSeek-V3, and the port's fault
replay in bfloat16, bit for bit, with the MTP head in the checkpoint."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models.layers import flash_attention as jax_flash
from repro.models.transformer import init_lm_params as jax_init
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw
from repro.optim import init_opt_state as jax_init_opt
from repro.runtime import Trainer as JaxTrainer
from repro.runtime import TrainerConfig as JaxTrainerConfig

from _lm_cases import flash_inputs
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_arrays_from_model, lm_params_from_arrays
from repro_torch.data import lm_token_stream
from repro_torch.kernels.flash_attn import ops as flash
from repro_torch.kernels.flash_attn.ref import flash_attention_bwd_ref
from repro_torch.models import init_lm_params, lm_loss
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.runtime import FaultInjector, Trainer, TrainerConfig

torch.set_num_threads(1)

LOSS_TOL = 1e-5       # relative
GRAD_TOL = 1e-4       # of the leaf's largest |reference gradient|
TRAINER_TOL = 1e-4    # relative, per step's loss
OPT_TOL = 1e-6        # one AdamW step, every leaf
FLASH_TOL = 1e-5      # float32 against float32, sums in another order
B, S = 2, 16
DSV3 = "deepseek-v3-671b"
# (arch, config overrides): the MTP head over MLA and over GQA
LOSS_CASES = {"dsv3": (DSV3, {}), "qwen3_mtp": ("qwen3-4b", dict(mtp_depth=1))}


def _configs(arch, dtype="float32", **over):
    return (dataclasses.replace(jax_reduced(arch), dtype=dtype, **over),
            dataclasses.replace(get_reduced(arch), dtype=dtype, **over))


def _leaves(tree, prefix=""):
    """``{path: array}`` of a nested dict, None subtrees left out."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {} if tree is None else {prefix[:-1]: np.asarray(tree, np.float32)}


def _ref_params(arch, jcfg, seed=0):
    """The reference's parameters; DeepSeek-V3's ``router_bias`` nonzero,
    so the aux-free selection differs from the gates' order."""
    params = jax_init(jax.random.PRNGKey(seed), jcfg)
    if arch == DSV3:
        ffn = params["moe_stack"]["ffn"]
        ffn["router_bias"] = jnp.asarray(np.random.default_rng(2).normal(
            0, 0.5, ffn["router_bias"].shape), jnp.float32)
    return params


def _port(params, cfg):
    return lm_params_from_arrays(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu")


@pytest.fixture(scope="module")
def loss_cases():
    """The reference's loss and gradients, once per (case, xent)."""
    out = {}
    for case, (arch, over) in LOSS_CASES.items():
        jcfg, _ = _configs(arch, **over)
        params = _ref_params(arch, jcfg)
        rng = np.random.default_rng(3)
        tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
        labels = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
        for xent in ("sharded", "chunked"):
            f = jax.jit(jax.value_and_grad(
                lambda p, t, l: jax_lm_loss(p, jcfg, t, l, xent=xent,
                                            xent_chunk=96, remat=False)))
            loss, grads = f(params, tokens, labels)
            out[case, xent] = (params, tokens, labels, float(loss),
                               _leaves(grads))
    return out


@pytest.mark.parametrize("xent", ["sharded", "chunked"])
@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_lm_loss_and_grads_match_reference(case, xent, loss_cases):
    params, tokens, labels, want_loss, want_grads = loss_cases[case, xent]
    arch, over = LOSS_CASES[case]
    _, cfg = _configs(arch, **over)
    model = _port(params, cfg).requires_grad_(True)
    loss = lm_loss(model, torch.from_numpy(tokens), torch.from_numpy(labels),
                   xent=xent, xent_chunk=96)
    assert abs(float(loss.detach()) - want_loss) <= LOSS_TOL * abs(want_loss)
    loss.backward()
    got = _leaves(lm_arrays_from_model(model, grad=True))
    assert set(got) == set(want_grads)
    assert any(k.startswith("mtp/") for k in got)
    for k, want in want_grads.items():
        assert got[k].shape == want.shape, k
        err = np.abs(got[k] - want).max()
        assert err <= GRAD_TOL * np.abs(want).max(), (k, err)
    if arch == DSV3:
        # MLA's weights take gradients; the aux-free router's bias none,
        # as in the reference (zeros)
        for name in ("w_dq", "w_uq", "w_dkv", "w_kr", "w_uk", "w_uv",
                     "q_norm", "kv_norm"):
            assert np.abs(got[f"mtp/block/attn/{name}"]).max() > 0, name
        assert model.blocks[1].ffn["router_bias"].grad is None
        assert not want_grads["moe_stack/ffn/router_bias"].any()


@pytest.mark.parametrize("causal", [True, False], ids=["causal",
                                                       "non_causal"])
def test_flash_bwd_ref_at_mla_widths_matches_reference_grad(causal):
    """The plain backward at the reduced config's (D, Dv) = (24, 16), GQA
    4/2, ragged against the reference's 16-row chunks."""
    q, k, v = flash_inputs(2, 40, 40, 4, 2, 24, seed=5, Dv=16)
    do = np.random.default_rng(6).standard_normal((2, 40, 4, 16),
                                                  dtype=np.float32)

    def f(q, k, v):
        o = jax_flash(q, k, v, causal=causal, q_chunk=16, kv_chunk=16)
        return jnp.sum(o * do)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash.flash_attention_plain(q, k, v, causal, return_lse=True)
    got = flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    for g, w, shape in zip(got, want, ((2, 40, 4, 24), (2, 40, 2, 24),
                                       (2, 40, 2, 16))):
        assert tuple(g.shape) == shape
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= FLASH_TOL * np.abs(w).max()
    # the wrapper on a CPU tensor: o and do of width Dv
    assert all(torch.equal(a, b) for a, b in zip(
        flash.flash_attention_bwd_k(q, k, v, o, lse, do, causal), got))


def test_flash_bwd_k_checks_widths():
    """o and do must be Dv wide; the card's kernels take the forward's
    widths, D <= 192 and Dv <= 128."""
    q, k, v = (torch.from_numpy(a) for a in flash_inputs(1, 8, 8, 4, 2, 24,
                                                         Dv=16))
    o, lse = flash.flash_attention_plain(q, k, v, return_lse=True)
    with pytest.raises(ValueError):
        flash.flash_attention_bwd_k(q, k, v, q, lse, q)   # D wide, not Dv
    assert (flash.BWD_MAX_HEAD_DIM, flash.BWD_MAX_V_DIM) == (
        flash.MAX_HEAD_DIM, flash.MAX_V_DIM) == (192, 128)


def test_decayed_params_follow_reference_rule():
    """Every per-layer tensor (stacked in the reference), the embedding,
    the head and the MTP head's matrices; not ``final_norm``, ``mtp.norm``
    or the MTP block's 1-D tensors."""
    model = init_lm_params(torch.Generator(), get_reduced(DSV3),
                           device="cpu")
    decay = model.decayed_params()
    names = dict(model.named_parameters())
    for name in ("blocks.0.ln1", "blocks.0.attn.q_norm", "blocks.0.attn.wo",
                 "blocks.1.ffn.router_bias", "blocks.1.ffn.router",
                 "blocks.1.ffn.wg", "embed", "lm_head", "mtp.proj",
                 "mtp.block.attn.w_dq", "mtp.block.ffn.wd"):
        assert name in decay, name
    for name in ("final_norm", "mtp.norm", "mtp.block.ln1",
                 "mtp.block.attn.kv_norm"):
        assert name in names and name not in decay, name
    assert decay == {n for n, p in names.items()
                     if p.ndim >= 2 or n.startswith("blocks.")}


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmoe-1b-7b", DSV3])
def test_adamw_step_matches_reference(arch):
    """One AdamW step at lr 1e-2 (weight decay 0.1, clipping on) from the
    same parameters and seeded gradients: parameters and both moments
    equal the reference's on every leaf, the per-layer norms and biases
    (QKV biases of Qwen1.5, q/k norms of OLMoE, MLA's norms and the
    router bias of DeepSeek-V3) decayed as the stacked tree decays them."""
    jcfg, cfg = _configs(arch)
    params = _ref_params(arch, jcfg)
    rng = np.random.default_rng(4)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.01,
                              jnp.float32), params)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    want, state, _ = jax.jit(jax_adamw, static_argnums=3)(
        params, grads, jax_init_opt(params, JaxAdamWConfig(**kw)),
        JaxAdamWConfig(**kw))

    model = _port(params, cfg)
    tp = dict(model.named_parameters())
    tg = dict(_port(grads, cfg).named_parameters())
    tstate = init_opt_state(tp, AdamWConfig(**kw))
    adamw_update(tp, tg, tstate, AdamWConfig(**kw), model.decayed_params())
    for got, ref in ((tp, want), (tstate["mu"], state["mu"]),
                     (tstate["nu"], state["nu"])):
        ref = dict(_port(ref, cfg).named_parameters())
        assert set(got) == set(ref)
        for name, t in got.items():
            np.testing.assert_allclose(t.detach().numpy(),
                                       ref[name].detach().numpy(),
                                       rtol=OPT_TOL, atol=OPT_TOL,
                                       err_msg=name)


def _loss_fn(m, b):
    return lm_loss(m, torch.from_numpy(b["tokens"]),
                   torch.from_numpy(b["labels"]))


def test_trainer_matches_reference(tmp_path):
    """Five steps of the port's Trainer against the reference's on the
    same data: each loss within TRAINER_TOL.  The aux-free router's bias
    takes a zero gradient in both (the port's ``None`` filled with
    zeros), so through clipping and AdamW it only decays, equally."""
    jcfg, cfg = _configs(DSV3)
    params = _ref_params(DSV3, jcfg)
    model = _port(params, cfg)
    start = np.asarray(params["moe_stack"]["ffn"]["router_bias"][0])
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jtr = JaxTrainer(
        lambda p, b: jax_lm_loss(p, jcfg, jnp.asarray(b["tokens"]),
                                 jnp.asarray(b["labels"])),
        params, JaxAdamWConfig(**opt),
        JaxTrainerConfig(ckpt_dir=str(tmp_path / "jax"), ckpt_every=1000,
                         log_every=1000))
    tr = Trainer(_loss_fn, model, AdamWConfig(**opt),
                 TrainerConfig(ckpt_dir=str(tmp_path / "port"),
                               ckpt_every=1000, log_every=1000))

    def data():
        return lm_token_stream(cfg.vocab, 2, 12, seed=5)

    want = jtr.run(data(), 5, log=lambda s: None)
    got = tr.run(data(), 5, log=lambda s: None)
    assert [h["step"] for h in got] == [1, 2, 3, 4, 5]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= TRAINER_TOL * abs(w["loss"])
        assert abs(g["lr"] - w["lr"]) <= 1e-6 * w["lr"]
    bias = model.blocks[1].ffn["router_bias"].detach().numpy()
    want_bias = np.asarray(jtr.params["moe_stack"]["ffn"]["router_bias"][0])
    np.testing.assert_allclose(bias, want_bias, rtol=OPT_TOL, atol=OPT_TOL)
    assert np.abs(bias).max() < np.abs(start).max()   # decayed, not frozen


def test_fault_replay_bit_exact(tmp_path):
    """Reduced DeepSeek-V3 in bfloat16: a fault at step 8 restores step
    5's checkpoint, which holds the MTP head, and replays: the losses of
    steps 6-10 equal an uninterrupted run's bit for bit."""
    _, cfg = _configs(DSV3, dtype="bfloat16")

    def run(tag, fault):
        model = init_lm_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
        tr = Trainer(_loss_fn, model,
                     AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=30),
                     TrainerConfig(ckpt_dir=str(tmp_path / tag),
                                   ckpt_every=5, log_every=1000))
        logs = []
        hist = tr.run(lm_token_stream(cfg.vocab, 4, 24, seed=7), 10,
                      fault=fault, log=logs.append)
        tr.finish()
        return {h["step"]: h["loss"] for h in hist}, logs

    l1, logs = run("a", FaultInjector(fail_at={8}))
    l2, _ = run("b", None)
    assert len(logs) == 1 and "injected fault at step 8" in logs[0]
    for s in range(6, 11):
        assert l1[s] == l2[s]
    assert l2[10] < l2[1]
    manifest = json.loads((tmp_path / "a" / "step_00000005" /
                           "manifest.json").read_text())
    assert "mtp.proj" in json.dumps(manifest)
