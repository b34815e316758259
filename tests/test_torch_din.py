"""The port's DIN against the reference on the CPU: ``embedding_bag``,
the regular bags' closed-form plan, ``TableGather``'s gradient, the
reduced DIN's logits, loss, every gradient and retrieval scores (the
reference's parameters from ``init_din(PRNGKey(0))`` carried across by
``din_params_from_arrays``), the data stream, one AdamW step on the DIN
tree, and the serving example.  Outputs are held to a relative 1e-4 in
float32 and 5e-2 in bfloat16 (max |port - reference| over max
|reference|, per leaf for gradients).  The port sums bags and table
gradients in float32, rounded once, as the TPU kernel does."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.data import din_batch_stream as jax_din_stream
from repro.models import recsys as jrec
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw
from repro.optim import init_opt_state as jax_init_opt

from repro_torch.configs import get_reduced
from repro_torch.convert import din_arrays_from_model, din_params_from_arrays
from repro_torch.data import din_batch_stream
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.models import (DINBatch, DINModel, TableGather, din_logits,
                                din_loss, embedding_bag, retrieval_scores)
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, N_CAND = 16, 64
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "serve_din_torch.py"


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(tree, prefix=""):
    """``{path: float32 array}`` of a nested dict/list."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree, np.float32)}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}{k}/"))
    return out


@pytest.fixture(scope="module")
def ref_fns():
    """The reference's functions, jitted once for the module (the config
    is static)."""
    return dict(
        logits=jax.jit(jrec.din_logits, static_argnums=1),
        loss_grad=jax.jit(jax.value_and_grad(jrec.din_loss),
                          static_argnums=1),
        retrieval=jax.jit(jrec.retrieval_scores, static_argnums=1))


@pytest.fixture(scope="module")
def ref_init():
    """The reference's ``init_din(PRNGKey(0))`` of the reduced config in
    float32, as numpy arrays.  Its bf16 parameters are these cast to
    bf16 (``_init`` draws in float32 and casts), so one draw serves both
    dtypes."""
    cfg = dataclasses.replace(jax_reduced("din"), dtype="float32")
    return jax.tree.map(np.asarray, jax.jit(jrec.init_din, static_argnums=1)(
        jax.random.PRNGKey(0), cfg))


def _seeded_params(jcfg, seed: int) -> dict:
    """Float32 parameters in the reference's tree (its structure from
    ``jax.eval_shape`` of ``init_din``), drawn with numpy: the tables
    N(0, 0.01²), the weights N(0, 1/fan_in), the biases N(0, 0.1²) (not
    0, which no decay changes)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        scale = (0.01 if name.endswith("_table']") else
                 0.1 if name.endswith("['b']") else s.shape[0] ** -0.5)
        return (scale * rng.normal(size=s.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jrec.init_din(k, jcfg),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batch_arrays(cfg, seed: int = 3) -> dict:
    return next(din_batch_stream(cfg.n_items, cfg.n_cates, cfg.n_user_feats,
                                 B, cfg.seq_len, seed=seed))


def _bag_case(dtype, weighted: bool, rng):
    """A (10, 3) table, ids with two out of range, irregular bags (bag 2
    empty) and per-id weights."""
    table = rng.normal(size=(10, 3)).astype(np.float32)
    ids = np.array([1, 2, 3, 7, -2, 12, 3, 3], np.int32)
    seg = np.array([0, 0, 1, 1, 1, 3, 3, 4], np.int32)
    w = rng.normal(size=len(ids)).astype(np.float32) if weighted else None
    jt = jnp.asarray(table, jnp.dtype(dtype))
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    return table, ids, seg, w, jt, tt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(mode, weighted, dtype):
    rng = np.random.default_rng(0)
    table, ids, seg, w, jt, tt = _bag_case(dtype, weighted, rng)
    want = jrec.embedding_bag(jt, jnp.asarray(ids), jnp.asarray(seg), 5,
                              None if w is None else jnp.asarray(w),
                              mode=mode)
    got = embedding_bag(tt, torch.from_numpy(ids), torch.from_numpy(seg), 5,
                        None if w is None else torch.from_numpy(w),
                        mode=mode)
    assert got.shape == (5, 3) and got.dtype == tt.dtype
    assert _rel(got.float(), np.asarray(want, np.float32)) <= TOL[dtype]
    assert not got[2].any()                                # the empty bag
    # out-of-range ids read the first and last rows
    clipped = embedding_bag(tt, torch.from_numpy(np.clip(ids, 0, 9)),
                            torch.from_numpy(seg), 5,
                            None if w is None else torch.from_numpy(w),
                            mode=mode)
    assert torch.equal(got, clipped)


@pytest.mark.parametrize("n_bags,bag_size", [
    (7, 4), (1, 1), (3, spmm_ops.HUB_DEGREE + 2), (0, 4), (5, 0)])
def test_bag_plan_equals_segment_plan(n_bags, bag_size):
    plan = spmm_ops.bag_plan(n_bags, bag_size, torch.device("cpu"))
    dst = torch.arange(n_bags).repeat_interleave(bag_size)
    want = spmm_ops.segment_plan(dst, n_bags)
    for f in dataclasses.fields(want):
        a, b = getattr(plan, f.name), getattr(want, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    assert plan.n_heavy == (n_bags if bag_size > spmm_ops.HUB_DEGREE else 0)
    assert spmm_ops.bag_plan(n_bags, bag_size, torch.device("cpu")) is plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_gather_grad_equals_index_select_grad(dtype):
    """Repeated ids, integer-valued gradients (every sum exact in both
    dtypes): the gradient equals autograd's ``index_select`` backward bit
    for bit, and rows no id touches get 0."""
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 20, 60).astype(np.int32))
    d_rows = torch.from_numpy(rng.integers(-4, 5, (60, 5))).to(dtype)
    table = torch.randn(24, 5).to(dtype)

    def grad(gather):
        t = table.clone().requires_grad_(True)
        (gather(t) * d_rows).sum().backward()
        return t.grad

    got = grad(lambda t: TableGather.apply(t, ids))
    want = grad(lambda t: t.index_select(0, ids.long()))
    assert got.dtype == dtype and torch.equal(got, want)
    untouched = np.setdiff1d(np.arange(24), ids.numpy())
    assert len(untouched) and not got[untouched].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_din_matches_reference(dtype, ref_fns, ref_init):
    """Logits, loss, every gradient, retrieval scores and their top 10
    (scores, not ids: candidates repeat items, so ties are certain)."""
    jcfg = dataclasses.replace(jax_reduced("din"), dtype=dtype)
    cfg = dataclasses.replace(get_reduced("din"), dtype=dtype)
    params = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)), ref_init)
    model = DINModel(cfg, din_params_from_arrays(params, cfg, device="cpu"))
    arrays = _batch_arrays(cfg)
    jb = jrec.DINBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    batch = DINBatch.from_arrays(arrays, device="cpu")
    tol = TOL[dtype]

    assert _rel(din_logits(model.params, cfg, batch).float(),
                ref_fns["logits"](params, jcfg, jb)) <= tol
    jloss, jgrads = ref_fns["loss_grad"](params, jcfg, jb)
    model.requires_grad_(True)
    loss = din_loss(model.params, cfg, batch)
    loss.backward()
    assert loss.dtype == torch.float32
    assert _rel(loss.detach(), jloss) <= tol
    want, got = _leaves(jgrads), _leaves(din_arrays_from_model(model, True))
    assert set(got) == set(want) and len(want) == 15
    for k, w in want.items():
        assert _rel(got[k], w) <= tol, k

    cand = np.arange(N_CAND * 3, dtype=np.int32) % N_CAND
    with torch.no_grad():
        sc = retrieval_scores(model.params, cfg, batch,
                              torch.from_numpy(cand),
                              torch.from_numpy(cand % cfg.n_cates)).float()
    jsc = ref_fns["retrieval"](params, jcfg, jb, jnp.asarray(cand),
                               jnp.asarray(cand % cfg.n_cates))
    assert sc.shape == (B, N_CAND * 3) and _rel(sc, jsc) <= tol
    assert _rel(torch.topk(sc, 10).values,
                jax.lax.top_k(jsc.astype(jnp.float32), 10)[0]) <= tol


def test_din_batch_stream_matches_reference():
    cfg = get_reduced("din")
    args = (cfg.n_items, cfg.n_cates, cfg.n_user_feats, B, cfg.seq_len)
    for got, want in zip(din_batch_stream(*args, seed=5, n_steps=2),
                         jax_din_stream(*args, seed=5, n_steps=2)):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_adamw_step_matches_reference_on_din_tree():
    """One step with weight decay 0.1 from seeded parameters: equal to
    the reference's leaf by leaf.  The default
    rule decays the tables and weights (ndim >= 2) and spares the biases,
    as the reference's does: their step equals the step without decay."""
    jcfg, cfg = jax_reduced("din"), dataclasses.replace(
        get_reduced("din"), dtype="float32")
    rng = np.random.default_rng(2)
    params = _seeded_params(jcfg, seed=1)
    grads = jax.tree.map(
        lambda a: (0.3 * rng.normal(size=a.shape)).astype(np.float32),
        params)

    def step(wd):
        kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=wd)
        model = DINModel(cfg, din_params_from_arrays(params, cfg, "cpu"))
        tp = dict(model.named_parameters())
        tg = dict(DINModel(cfg, din_params_from_arrays(
            grads, cfg, "cpu")).named_parameters())
        adamw_update(tp, tg, init_opt_state(tp, AdamWConfig(**kw)),
                     AdamWConfig(**kw))
        return _leaves(din_arrays_from_model(model))

    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
    jp, _, _ = jax.jit(lambda p, g: jax_adamw(
        p, g, jax_init_opt(p, JaxAdamWConfig(**kw)), JaxAdamWConfig(**kw)))(
        params, grads)
    want, got, undecayed = _leaves(jp), step(0.1), step(0.0)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
        assert np.array_equal(got[k], undecayed[k]) == k.endswith("/b"), k


def test_serve_din_example_on_cpu(ref_fns):
    """The example's 300 training steps (the loss falls), its batched
    scoring and its retrieval, on the CPU; the top 10 scores against the
    reference's on the trained weights.  The example holds the AUC to
    0.65, which neither package reaches after 300 steps (ROADMAP.md item
    26), so the AUC is only computed here."""
    spec = importlib.util.spec_from_file_location("serve_din_torch", EXAMPLE)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    cfg, cpu = get_reduced("din"), torch.device("cpu")
    model, losses = ex.train(cfg, cpu)
    assert len(losses) == ex.TRAIN_STEPS and losses[-1] < losses[0]
    test = ex.scoring_batch(cfg, cpu)
    assert 0.0 <= ex.serve_auc(model, test) <= 1.0
    top, ids = ex.retrieve(model, test)
    cand = np.arange(ex.N_CANDIDATES) % cfg.n_items
    jb = jrec.DINBatch(**{f: jnp.asarray(t[:1].numpy())
                          for f, t in vars(test).items()})
    jsc = ref_fns["retrieval"](din_arrays_from_model(model),
                               jax_reduced("din"), jb,
                               jnp.asarray(cand),
                               jnp.asarray(cand % cfg.n_cates))
    assert ids.shape == (10,)
    assert _rel(top, jax.lax.top_k(jsc[0], 10)[0]) <= TOL[cfg.dtype]
