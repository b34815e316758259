"""The port's LM training stack against the reference's, on the CPU:
``lm_token_stream`` equal to the reference's; one AdamW step and the int8
error-feedback round trip within 1e-6; a checkpoint round trip (bf16
included); ``lm_loss`` with both cross entropies and every parameter's
gradient against ``jax.value_and_grad`` of the reference's ``lm_loss`` on
reduced OLMoE (MoE, qk-norm) and reduced Qwen1.5-0.5B (tied embeddings,
QKV bias) in float32, parameters carried over by
``lm_params_from_arrays`` and gradients read back by
``lm_arrays_from_model`` (loss within a relative 1e-5, each gradient
leaf within 1e-4 of its largest reference magnitude); five ``Trainer``
steps against the reference's ``Trainer`` on the same data, plain and
with gradient accumulation and int8 compression (losses within 1e-4);
and the port's own fault replay, bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_reduced as jax_reduced
from repro.data import lm_token_stream as jax_stream
from repro.distributed.compression import compress_roundtrip as jax_compress
from repro.models.transformer import init_lm_params as jax_init
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw
from repro.optim import init_opt_state as jax_init_opt
from repro.runtime import Trainer as JaxTrainer
from repro.runtime import TrainerConfig as JaxTrainerConfig

from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_arrays_from_model, lm_params_from_arrays
from repro_torch.data import Prefetcher, lm_token_stream
from repro_torch.distributed.compression import (compress_roundtrip,
                                                 init_error_feedback)
from repro_torch.models import lm_loss
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.runtime import FaultInjector, Trainer, TrainerConfig

torch.set_num_threads(1)

LOSS_TOL = 1e-5       # relative
GRAD_TOL = 1e-4       # of the leaf's largest |reference gradient|
TRAINER_TOL = 1e-4    # relative, per step's loss
B, S = 2, 16
ARCHS = ("olmoe-1b-7b", "qwen1.5-0.5b")


def _configs(arch):
    return (dataclasses.replace(jax_reduced(arch), dtype="float32"),
            dataclasses.replace(get_reduced(arch), dtype="float32"))


def _leaves(tree, prefix=""):
    """``{path: array}`` of a nested dict, None subtrees left out."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {} if tree is None else {prefix[:-1]: np.asarray(tree, np.float32)}


def test_lm_token_stream_matches_reference():
    for seed in (0, 7):
        ours = lm_token_stream(97, 3, 11, seed=seed, n_steps=3)
        for want, got in zip(jax_stream(97, 3, 11, seed=seed, n_steps=3),
                             Prefetcher(ours)):
            for key in ("tokens", "labels"):
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])


def _opt_inputs():
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((6, 5), dtype=np.float32),
              "b": rng.standard_normal((5,), dtype=np.float32),
              "e": rng.standard_normal((3, 4, 2), dtype=np.float32)}
    grads = [{k: rng.standard_normal(v.shape, dtype=np.float32) * 0.3
              for k, v in params.items()} for _ in range(3)]
    return params, grads


def test_adamw_matches_reference():
    """Three steps (warmup, bias correction, clipping at a small
    clip_norm, decay only of the 2-D and 3-D tensors)."""
    params, grads = _opt_inputs()
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jax_init_opt(jp, JaxAdamWConfig(**kw))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = init_opt_state(tp, AdamWConfig(**kw))
    for g in grads:
        jp, jstate, jinfo = jax_adamw(jp, {k: jnp.asarray(v)
                                           for k, v in g.items()},
                                      jstate, JaxAdamWConfig(**kw))
        tp, tstate, tinfo = adamw_update(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, tstate,
            AdamWConfig(**kw))
        assert abs(tinfo["lr"] - float(jinfo["lr"])) <= 1e-6 * float(
            jinfo["lr"])
        assert abs(float(tinfo["grad_norm"]) - float(jinfo["grad_norm"])) \
            <= 1e-6 * float(jinfo["grad_norm"])
        for k in params:
            for got, want in ((tp[k], jp[k]), (tstate["mu"][k],
                                               jstate["mu"][k]),
                              (tstate["nu"][k], jstate["nu"][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-6)
        assert int(tstate["step"]) == int(jstate["step"])


def test_compress_roundtrip_matches_reference():
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((7, 9), dtype=np.float32),
         "b": rng.standard_normal((13,), dtype=np.float32) * 1e-3}
    err = {k: rng.standard_normal(v.shape, dtype=np.float32) * 1e-3
           for k, v in g.items()}
    want_g, want_e = jax_compress({k: jnp.asarray(v) for k, v in g.items()},
                                  {k: jnp.asarray(v) for k, v in err.items()})
    got_g, got_e = compress_roundtrip(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in err.items()})
    for k in g:
        np.testing.assert_allclose(got_g[k].numpy(), np.asarray(want_g[k]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_e[k].numpy(), np.asarray(want_e[k]),
                                   rtol=1e-6, atol=1e-6)
    zero = init_error_feedback({k: torch.from_numpy(v) for k, v in g.items()})
    assert all(z.dtype == torch.float32 and not z.any() for z in zero.values())


def test_checkpoint_roundtrip(tmp_path):
    """bf16 and int leaves come back with their dtypes and values (as
    they were when the save returned, whatever the caller does to them
    while the thread writes), a None leaf is skipped, ``keep`` prunes the
    older steps, ``into`` loads in place, and the layout is the
    reference's (a step directory with leaves.npz and manifest.json)."""
    tree = dict(params={"blocks.0.w": torch.arange(8, dtype=torch.bfloat16)
                        / 3, "emb": torch.randn(3, 4)},
                opt_state=dict(mu={"emb": torch.ones(3, 4)},
                               step=torch.tensor(5, dtype=torch.int32)),
                err_fb=None)
    path = str(tmp_path / "ck")
    want = {k: v.clone() for k, v in tree["params"].items()}
    for step in (3, 7):
        th = save_checkpoint(path, step, tree, blocking=False, keep=1)
        for v in tree["params"].values():   # updated while the thread writes
            v.add_(1)
        th.join()
        for k, v in tree["params"].items():
            v.copy_(want[k])
    assert latest_step(path) == 7
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000007"]
    assert {p.name for p in (tmp_path / "ck" / "step_00000007").iterdir()} \
        == {"leaves.npz", "manifest.json"}
    like = dict(params={k: torch.zeros_like(v)
                        for k, v in tree["params"].items()},
                opt_state=dict(mu={"emb": torch.zeros(3, 4)},
                               step=torch.tensor(0, dtype=torch.int32)),
                err_fb=None)
    back, step = load_checkpoint(path, like)
    assert step == 7 and back["err_fb"] is None
    for key in ("blocks.0.w", "emb"):
        assert back["params"][key].dtype == tree["params"][key].dtype
        assert torch.equal(back["params"][key], tree["params"][key])
    assert back["opt_state"]["step"].dtype == torch.int32
    assert int(back["opt_state"]["step"]) == 5
    into, _ = load_checkpoint(path, like, into=True)
    assert into["params"]["emb"] is like["params"]["emb"]
    assert torch.equal(like["params"]["emb"], tree["params"]["emb"])
    # the reference writes the same layout
    jax_save(str(tmp_path / "ref"), 7, {"a": jnp.ones(3)}, blocking=True)
    assert latest_step(str(tmp_path / "ref")) == 7


@pytest.fixture(scope="module")
def loss_cases():
    """The reference's loss and gradients, once per (arch, xent); without
    its per-block ``jax.checkpoint``, which changes no value and doubles
    the compile time."""
    out = {}
    for arch in ARCHS:
        jcfg, cfg = _configs(arch)
        params = jax_init(jax.random.PRNGKey(0), jcfg)
        rng = np.random.default_rng(3)
        tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        for xent in ("sharded", "chunked"):
            f = jax.jit(jax.value_and_grad(
                lambda p, t, l: jax_lm_loss(p, jcfg, t, l, xent=xent,
                                            xent_chunk=96, remat=False)))
            loss, grads = f(params, tokens, labels)
            out[arch, xent] = (params, tokens, labels, float(loss),
                               _leaves(grads))
    return out


@pytest.mark.parametrize("xent", ["sharded", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch, xent, loss_cases):
    params, tokens, labels, want_loss, want_grads = loss_cases[arch, xent]
    _, cfg = _configs(arch)
    model = lm_params_from_arrays(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu").requires_grad_(True)
    # the parameters survive the trip there and back exactly
    for k, v in _leaves(lm_arrays_from_model(model)).items():
        np.testing.assert_array_equal(v, _leaves(jax.tree.map(
            np.asarray, params))[k])
    loss = lm_loss(model, torch.from_numpy(tokens), torch.from_numpy(labels),
                   xent=xent, xent_chunk=96)
    assert abs(float(loss.detach()) - want_loss) <= LOSS_TOL * abs(want_loss)
    loss.backward()
    got = _leaves(lm_arrays_from_model(model, grad=True))
    assert set(got) == set(want_grads)
    for k, want in want_grads.items():
        assert got[k].shape == want.shape, k
        err = np.abs(got[k] - want).max()
        assert err <= GRAD_TOL * np.abs(want).max(), (k, err)


def _trainers(tmp_path, tag, **tkw):
    """The reference's Trainer and the port's on reduced Qwen1.5-0.5B in
    float32, from the same parameters."""
    jcfg, cfg = _configs("qwen1.5-0.5b")
    params = jax_init(jax.random.PRNGKey(0), jcfg)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jtr = JaxTrainer(
        lambda p, b: jax_lm_loss(p, jcfg, jnp.asarray(b["tokens"]),
                                 jnp.asarray(b["labels"])),
        params, JaxAdamWConfig(**opt),
        JaxTrainerConfig(ckpt_dir=str(tmp_path / f"jax_{tag}"),
                         ckpt_every=1000, log_every=1000, **tkw))
    model = lm_params_from_arrays(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    tr = Trainer(lambda m, b: lm_loss(m, torch.from_numpy(b["tokens"]),
                                      torch.from_numpy(b["labels"])),
                 model, AdamWConfig(**opt),
                 TrainerConfig(ckpt_dir=str(tmp_path / f"port_{tag}"),
                               ckpt_every=1000, log_every=1000, **tkw))
    return cfg, jtr, tr


def _accum(stream, n):
    """Stack ``n`` consecutive batches on a leading microbatch axis."""
    while True:
        mbs = [next(stream) for _ in range(n)]
        yield {k: np.stack([m[k] for m in mbs]) for k in mbs[0]}


@pytest.mark.parametrize("tkw", [{}, dict(grad_accum=2,
                                          grad_compression="int8_ef")],
                         ids=["plain", "accum2_int8ef"])
def test_trainer_matches_reference(tmp_path, tkw):
    cfg, jtr, tr = _trainers(tmp_path, "x", **tkw)
    n = tkw.get("grad_accum", 1)

    def data():
        stream = lm_token_stream(cfg.vocab, 2, 12, seed=5)
        return _accum(stream, n) if n > 1 else stream

    want = jtr.run(data(), 5, log=lambda s: None)
    got = tr.run(data(), 5, log=lambda s: None)
    assert [h["step"] for h in got] == [1, 2, 3, 4, 5]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= TRAINER_TOL * abs(w["loss"])
        assert abs(g["lr"] - w["lr"]) <= 1e-6 * w["lr"]


def test_fault_replay_bit_exact(tmp_path):
    """A fault at step 8 restores step 5's checkpoint and replays: the
    losses of steps 6-10 equal an uninterrupted run's bit for bit."""
    _, cfg = _configs("qwen1.5-0.5b")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")

    def run(tag, fault):
        from repro_torch.models import init_lm_params
        model = init_lm_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
        tr = Trainer(lambda m, b: lm_loss(m, torch.from_numpy(b["tokens"]),
                                          torch.from_numpy(b["labels"])),
                     model, AdamWConfig(lr=1e-3, warmup_steps=3,
                                        total_steps=30),
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
