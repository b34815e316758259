"""The port's GNN training against the reference's, on the CPU.

``gnn_loss`` and every gradient leaf of reduced GraphCast, SchNet (also
as a batch of molecules read out by ``graph_id``), PNA and GAT against
``jax.value_and_grad`` of the reference's ``gnn_loss`` in float32
(parameters carried across by ``gnn_params_from_arrays``, gradients read
back stacked by ``gnn_arrays_from_model``; the loss within a relative
1e-4, each gradient leaf within 1e-4 of its largest reference
magnitude).  The plain GAT aggregation differentiates through autograd
in float32 and bfloat16, and the kernels' plain backwards
(``gat_aggregate_bwd_plain``, from the forward's row statistics and
output, and ``segment_spmm_bwd_plain``) agree with autograd: in float32
at 1e-5, in bfloat16 at 2e-2 of the largest value against the
float32-accumulating plain backward.  The row statistics
(``gat_row_stats_plain``) equal the reference's segment max and
denominators, and the backward's ``delta_v = <dout_v, out_v>`` equals
the sum over v's edges that it replaces.  One AdamW step on a
model whose per-layer weights the reference stacks equals the
reference's on the stacked tree, biases included.  The sampler and
``gnn_epoch_stream`` give the reference's arrays; a short ``Trainer`` run
of GAT with a fault replays bit for bit."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.data.pipeline import gnn_epoch_stream as jax_epoch_stream
from repro.graph import erdos_graph as jax_erdos
from repro.graph.sampler import sample_neighbors as jax_sample
from repro.models.gnn import GraphBatch as JaxGraphBatch
from repro.models.gnn import _seg_max as jax_seg_max
from repro.models.gnn import _seg_sum as jax_seg_sum
from repro.models.gnn import gnn_loss as jax_gnn_loss
from repro.models.gnn import init_gnn as jax_init
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw
from repro.optim import init_opt_state as jax_init_opt

from _gnn_cases import (ALL_MASKED_NODE, D_FEAT, GAT_GRAPHS, GNN_ARCHS,
                        N_NODES, N_OUT, gat_graph_arrays, gat_kernel_inputs,
                        graph_arrays)
from repro_torch.configs import get_reduced
from repro_torch.convert import (gnn_arrays_from_model,
                                 gnn_params_from_arrays,
                                 graph_batch_from_arrays)
from repro_torch.data import gnn_epoch_stream
from repro_torch.graph import Graph, sample_capacities, sample_neighbors
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.models import GNNModel, gnn_loss
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.runtime import FaultInjector, Trainer, TrainerConfig

torch.set_num_threads(1)

LOSS_TOL = 1e-4       # relative
GRAD_TOL = 1e-4       # of the leaf's largest |reference gradient|
BF16_TOL = 2e-2       # of the largest |f32-accumulating plain backward|


def _configs(arch, dtype="float32"):
    return (dataclasses.replace(jax_reduced(arch), dtype=dtype),
            dataclasses.replace(get_reduced(arch), dtype=dtype))


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


def _arrays(kind):
    """The seeded graph with every third label masked out."""
    arrays = graph_arrays(kind)
    arrays["label_mask"] = np.arange(len(arrays["label_mask"])) % 3 != 0
    return arrays


def _molecules():
    """SchNet's batch of 4 molecules read out by ``graph_id``, as
    ``tests/test_arch_smoke.py`` builds it, drawn with numpy."""
    rng = np.random.default_rng(4)
    B, n, e = 4, 10, 18
    N = B * n
    return dict(
        node_feats=rng.normal(size=(N, D_FEAT)).astype(np.float32),
        edge_src=np.concatenate([rng.integers(0, n, e) + b * n
                                 for b in range(B)]).astype(np.int32),
        edge_dst=np.concatenate([rng.integers(0, n, e) + b * n
                                 for b in range(B)]).astype(np.int32),
        edge_mask=np.ones(B * e, bool),
        labels=rng.normal(size=B).astype(np.float32),
        label_mask=np.ones(N, bool),
        positions=(2.0 * rng.normal(size=(N, 3))).astype(np.float32),
        graph_id=np.repeat(np.arange(B), n).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _init(jcfg, seed=0):
    """The reference's parameters (``init_gnn`` under ``jit``, which here
    takes a fraction of the eager call's time), once per config and
    seed."""
    return jax.jit(lambda k: jax_init(k, jcfg, D_FEAT, N_OUT))(
        jax.random.PRNGKey(seed))


def _value_and_grad(jcfg, arrays, params):
    """The reference's ``gnn_loss`` and its gradients, under ``jit``
    (one compile; the eager call traces and compiles its ``lax.scan``
    anyway and takes several times longer)."""
    jgb = JaxGraphBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_gnn_loss(p, jcfg, jgb)))(params)
    return float(loss), _leaves(grads)


def _model(arch, params, dtype="float32"):
    _, cfg = _configs(arch, dtype)
    return GNNModel(cfg, gnn_params_from_arrays(
        jax.tree.map(np.asarray, params), cfg, device="cpu"))


@pytest.mark.parametrize("arch,graph", [(a, "seeded") for a in GNN_ARCHS]
                         + [("schnet", "molecules")])
def test_gnn_loss_and_grads_match_reference(arch, graph):
    jcfg, cfg = _configs(arch)
    arrays = _molecules() if graph == "molecules" else _arrays(cfg.kind)
    params = _init(jcfg)
    want_loss, want = _value_and_grad(jcfg, arrays, params)
    model = _model(arch, params).requires_grad_(True)
    # the parameters survive the trip there and back exactly
    for k, v in _leaves(gnn_arrays_from_model(model)).items():
        np.testing.assert_array_equal(v, _leaves(jax.tree.map(
            np.asarray, params))[k])
    loss = model.loss(graph_batch_from_arrays(arrays, device="cpu"))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss.detach()) - want_loss) <= LOSS_TOL * abs(want_loss)
    loss.backward()
    got = _leaves(gnn_arrays_from_model(model, grad=True))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        err = np.abs(got[k] - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (k, err)


def _gat_inputs(dtype, H=8, dout=7, zero_scores=False):
    """gat_aggregate's inputs on a graph with a hub, masked slots, an
    empty row and an all-masked row, with gradients on."""
    x = gat_kernel_inputs(H, dout, N=60, E=500, hub=200,
                          zero_scores=zero_scores)
    dt = getattr(torch, dtype)
    t = {k: torch.from_numpy(x[k]).to(dt).requires_grad_(True)
         for k in ("hw", "s_src", "s_dst")}
    src, dst, mask = (torch.from_numpy(x[k]) for k in ("src", "dst",
                                                       "mask"))
    plan = spmm_ops.segment_plan(dst, 60, src=src, mask=mask)
    dout_ = torch.from_numpy(np.random.default_rng(1).normal(
        size=x["hw"].shape).astype(np.float32))
    return t, plan, mask, dout_


@pytest.mark.parametrize("dtype,acc,scores", [
    *[(d, a, "random") for d in ("float32", "bfloat16")
      for a in ("float32", "bfloat16")],
    *[("float32", a, "zero_at_loops") for a in ("float32", "bfloat16")]])
def test_gat_aggregate_plain_backward(dtype, acc, scores):
    """``.backward()`` through ``gat_aggregate`` on CPU tensors (an
    in-place op on a saved tensor broke it), finite, masked and empty
    rows taking no gradient; autograd's gradients against
    ``gat_aggregate_bwd_plain`` (given the forward's row statistics and
    output, as the kernel is): at 1e-5 in float32, and in bfloat16 at
    2e-2 of the largest value of the float32-accumulating plain
    backward; in float32 also where self-loops' pre-activations are
    exactly 0 (in bfloat16 autograd's own roundings there are no
    yardstick for the slope)."""
    zero = scores == "zero_at_loops"
    t, plan, mask, dout_ = _gat_inputs(dtype, zero_scores=zero)
    acc_dt = getattr(torch, acc)
    out = spmm_ops.gat_aggregate(t["hw"], t["s_src"], t["s_dst"], plan,
                                 mask, acc_dt)
    g = dout_.to(acc_dt)
    out.backward(g)
    got = (t["hw"].grad, t["s_src"].grad, t["s_dst"].grad)
    assert all(bool(torch.isfinite(x).all()) for x in got)
    assert not got[2][ALL_MASKED_NODE].any()     # every in-slot masked
    assert not got[2][7].any()                   # no in-edge at all
    hw, s_src, s_dst = (t[k].detach() for k in ("hw", "s_src", "s_dst"))
    m, den = spmm_ops.gat_row_stats_plain(s_src, s_dst, plan, mask, acc_dt)
    want = spmm_ops.gat_aggregate_bwd_plain(hw, s_src, s_dst, plan, mask,
                                            acc_dt, g, m, den, out.detach())
    tol = 1e-5 if dtype == acc == "float32" else BF16_TOL
    for name, a, b in zip(("dhw", "ds_src", "ds_dst"), got, want):
        assert a.dtype == b.dtype == getattr(torch, dtype), name
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), (name, err)
    # the entry a model calls: plain autograd on the CPU
    t2, *_ = _gat_inputs(dtype, zero_scores=zero)
    spmm_ops.gat_aggregate_ad(t2["hw"], t2["s_src"], t2["s_dst"], plan,
                              mask, acc_dt,
                              lambda: spmm_ops.source_plan(plan)).backward(g)
    assert torch.equal(t2["hw"].grad, got[0])


@pytest.mark.parametrize("dtype,acc", [(d, a) for d in ("float32", "bfloat16")
                                       for a in ("float32", "bfloat16")])
def test_gat_row_stats_plain_match_reference(dtype, acc):
    """The row statistics that "gat" saves for its backward, plain
    (``gat_row_stats_plain``), against the reference layer's own
    ``_seg_max`` of the masked scores (equal, ``-inf`` on the empty and
    all-masked rows) and its denominators ``maximum(den, 1e-9)``, summed
    in float32 and rounded to the sums' dtype as the port's forward does
    (within 1e-6 relative in float32, one bfloat16 step in bfloat16);
    ``gat_aggregate_with_stats`` on the CPU gives them beside the plain
    output.  Both start from the port's scores: in bfloat16 the two
    frameworks round leaky_relu's ``0.2 * x`` apart by a step."""
    t, plan, mask, _ = _gat_inputs(dtype)
    s_src, s_dst = t["s_src"].detach(), t["s_dst"].detach()
    dst, N = plan.dst.numpy(), s_src.shape[0]
    score = jnp.asarray(spmm_ops._gat_scores(s_src, s_dst, plan.src,
                                             plan.dst).numpy())
    score = jnp.where(mask.numpy()[:, None], score, -jnp.inf)
    smax = jax_seg_max(score, dst, N)
    ex = jnp.exp(score - smax[dst]).astype(getattr(jnp, acc))
    ex = jnp.where(mask.numpy()[:, None], ex, 0)
    den = jax_seg_sum(ex.astype(jnp.float32), dst, N).astype(
        getattr(jnp, acc)).astype(jnp.float32)
    want_m, want_den = np.asarray(smax), np.asarray(jnp.maximum(den, 1e-9))
    acc_dt = getattr(torch, acc)
    m, got_den = spmm_ops.gat_row_stats_plain(s_src, s_dst, plan, mask,
                                              acc_dt)
    assert m.dtype == got_den.dtype == torch.float32
    assert m.shape == got_den.shape == s_src.shape
    np.testing.assert_array_equal(m.numpy(), want_m)
    assert np.isneginf(want_m[[7, ALL_MASKED_NODE]]).all()
    rtol = 1e-6 if acc == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got_den.numpy(), want_den, rtol=rtol, atol=0)
    out, m2, den2 = spmm_ops.gat_aggregate_with_stats(
        t["hw"].detach(), s_src, s_dst, plan, mask, acc_dt)
    assert torch.equal(out, spmm_ops.gat_aggregate(
        t["hw"].detach(), s_src, s_dst, plan, mask, acc_dt))
    assert torch.equal(m2, m) and torch.equal(den2, got_den)


@pytest.mark.parametrize("scores", ["random", "zero_at_loops"])
def test_gat_delta_identity(scores):
    """The backward's per-row ``delta_v = <dout_v, out_v>``, taken from
    the forward's output, equals ``T_v / den_v`` with ``T_v = sum over
    v's live edges of <dout_v, hw[u]> * ex_e``, the sum it replaces, to
    1e-5 of the largest value in float32."""
    t, plan, mask, dout_ = _gat_inputs(
        "float32", zero_scores=scores == "zero_at_loops")
    hw, s_src, s_dst = (t[k].detach() for k in ("hw", "s_src", "s_dst"))
    out, m, den = spmm_ops.gat_aggregate_with_stats(hw, s_src, s_dst, plan,
                                                    mask, torch.float32)
    delta = (dout_ * out).sum(-1)
    src, dst = plan.src.long(), plan.dst.long()
    sc = torch.where(mask[:, None], spmm_ops._gat_scores(s_src, s_dst, src,
                                                         dst), -np.inf)
    ex = torch.exp(sc - m[dst]).masked_fill(~mask[:, None], 0)
    dalpha = (dout_[dst] * hw[src]).sum(-1)
    T = torch.zeros_like(delta).index_add_(0, dst, dalpha * ex)
    want = T / den
    err = float((delta - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    assert not delta[7].any() and not delta[ALL_MASKED_NODE].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_spmm_plain_backward(dtype):
    """autograd through the plain segment sum is ``dout[dst]``, which
    ``segment_spmm_bwd_plain`` and ``segment_spmm_bwd`` on the CPU
    give."""
    rng = np.random.default_rng(0)
    dt = getattr(torch, dtype)
    msgs = torch.from_numpy(rng.normal(size=(300, 3, 4)).astype(
        np.float32)).to(dt).requires_grad_(True)
    dst = torch.from_numpy(rng.integers(0, 50, 300).astype(np.int32))
    out = spmm_ops.segment_spmm_ad(msgs, dst, 50, out_dtype=dt)
    dout_ = torch.from_numpy(rng.normal(size=(50, 3, 4)).astype(
        np.float32)).to(dt)
    out.backward(dout_)
    want = spmm_ops.segment_spmm_bwd_plain(dout_, dst, dt)
    assert torch.equal(msgs.grad, want)
    assert torch.equal(spmm_ops.segment_spmm_bwd(dout_, dst, 50, None, dt),
                       want)


def _opt_case(arch):
    """The reference's reduced parameters, moved off their initial values
    (its biases start at 0, which no decay changes), and one seeded
    gradient tree of the same shapes."""
    jcfg, _ = _configs(arch)
    rng = np.random.default_rng(2)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)).astype(
            np.float32),
        _init(jcfg))
    grads = jax.tree.map(
        lambda a: (0.3 * rng.normal(size=a.shape)).astype(np.float32),
        params)
    return params, grads


@pytest.mark.parametrize("arch", ["pna", "gat-cora"])
def test_adamw_step_matches_reference_on_stacked_tree(arch):
    """One AdamW step with weight decay: the reference decays every
    tensor of its stacked tree with ndim >= 2, so every per-layer tensor
    of PNA, biases included.  The port's per-layer biases are 1-D:
    by the shape rule alone (no ``decay``) they would not be decayed and
    the step would differ, so the model names what it decays."""
    params, grads = _opt_case(arch)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.5)
    jp, _, _ = jax.jit(lambda p, g: jax_adamw(
        p, g, jax_init_opt(p, JaxAdamWConfig(**kw)), JaxAdamWConfig(**kw)))(
        params, grads)
    want = _leaves(jp)

    def step(decay):
        model = _model(arch, params)
        tp = dict(model.named_parameters())
        tg = dict(_model(arch, grads).named_parameters())
        adamw_update(tp, tg, init_opt_state(tp, AdamWConfig(**kw)),
                     AdamWConfig(**kw),
                     model.decayed_params() if decay else None)
        return _leaves(gnn_arrays_from_model(model))

    got = step(decay=True)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    shape_rule = step(decay=False)
    differ = {k for k, w in want.items()
              if not np.allclose(shape_rule[k], w, rtol=1e-6, atol=1e-6)}
    if arch == "gat-cora":          # GAT is not stacked: the rules agree
        assert not differ
    else:
        assert differ and all(k.startswith("layers/") and k.endswith("/b")
                              for k in differ), differ


def _graphs():
    """The same seeded graph in both packages."""
    g = jax_erdos(300, 6.0, seed=3)
    return g, Graph(n=g.n, indptr=np.array(g.indptr),
                    indices=np.array(g.indices))


def test_sample_neighbors_matches_reference():
    g, tg = _graphs()
    fanout = (5, 3)
    assert sample_capacities(16, fanout) == (16 + 80 + 240, 80 + 240)
    for seed in (0, 1):
        seeds = np.random.default_rng(seed).choice(g.n, 16, replace=False)
        want = jax_sample(g, seeds, fanout, np.random.default_rng(seed))
        got = sample_neighbors(tg, seeds, fanout,
                               np.random.default_rng(seed))
        assert got.n_nodes == want.n_nodes
        for f in ("nodes", "edge_src", "edge_dst", "edge_mask",
                  "seed_mask"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_gnn_epoch_stream_matches_reference():
    g, tg = _graphs()
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(g.n, 6)).astype(np.float32)
    labels = rng.integers(0, 4, g.n).astype(np.int32)
    for want, got in zip(
            jax_epoch_stream(g, feats, labels, 8, (4, 3), seed=2, n_steps=3),
            gnn_epoch_stream(tg, feats, labels, 8, (4, 3), seed=2,
                             n_steps=3)):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_gnn_trainer_fault_replay_bit_exact(tmp_path):
    """Reduced GAT in bfloat16, full-graph steps on the seeded graph: a
    fault at step 7 restores step 5's checkpoint and replays; the losses
    of steps 6-9 equal an uninterrupted run's bit for bit, and the loss
    falls."""
    _, cfg = _configs("gat-cora", "bfloat16")
    arrays = _arrays("gat")

    def batches():
        while True:
            yield arrays

    def run(tag, fault):
        jcfg = dataclasses.replace(jax_reduced("gat-cora"), dtype="bfloat16")
        params = _init(jcfg, seed=1)
        tr = Trainer(lambda m, b: m.loss(graph_batch_from_arrays(
            b, device="cpu")), _model("gat-cora", params, "bfloat16"),
            AdamWConfig(lr=2e-2, warmup_steps=2, total_steps=20),
            TrainerConfig(ckpt_dir=str(tmp_path / tag), ckpt_every=5,
                          log_every=1000))
        logs = []
        hist = tr.run(batches(), 9, fault=fault, log=logs.append)
        tr.finish()
        return {h["step"]: h["loss"] for h in hist}, logs

    l1, logs = run("a", FaultInjector(fail_at={7}))
    l2, _ = run("b", None)
    assert len(logs) == 1 and "injected fault at step 7" in logs[0]
    for s in range(6, 10):
        assert l1[s] == l2[s]
    assert l2[9] < l2[1]


@pytest.mark.parametrize("case", GAT_GRAPHS)
def test_gat_loss_grads_on_edge_graphs(case):
    """GAT's loss gradients against the reference on the hub graph and
    the graph with an all-masked row (f32)."""
    jcfg, cfg = _configs("gat-cora")
    arrays = gat_graph_arrays(case)
    params = _init(jcfg)
    _, want = _value_and_grad(jcfg, arrays, params)
    model = _model("gat-cora", params).requires_grad_(True)
    gnn_loss(model.params, cfg, graph_batch_from_arrays(
        arrays, device="cpu")).backward()
    got = _leaves(gnn_arrays_from_model(model, grad=True))
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= GRAD_TOL * np.abs(w).max(), k


def test_gat_grads_match_reference_where_scores_are_zero():
    """The reference's leaky_relu is ``where(x >= 0, x, 0.2 * x)``, so
    its slope at 0 is 1.  With ``a_dst = -a_src`` in every layer, each
    self-loop's pre-activation ``s_src[v] + s_dst[v]`` is exactly 0 in
    both packages; the port's gradients match the reference's (f32)."""
    jcfg, cfg = _configs("gat-cora")
    arrays = graph_arrays("gat")
    loops = np.arange(0, N_NODES, 2, dtype=np.int32)
    arrays["edge_src"] = np.concatenate([arrays["edge_src"], loops])
    arrays["edge_dst"] = np.concatenate([arrays["edge_dst"], loops])
    arrays["edge_mask"] = np.concatenate([arrays["edge_mask"],
                                          np.ones(len(loops), bool)])
    params = jax.tree.map(np.asarray, _init(jcfg))
    for lyr in params["layers"]:
        lyr["a_dst"] = -lyr["a_src"]
    w0, a0 = params["layers"][0]["w"], params["layers"][0]["a_src"]
    jhw = (jnp.asarray(arrays["node_feats"]) @ w0).reshape(N_NODES,
                                                           *a0.shape)
    assert not np.asarray((jhw * a0).sum(-1) + (jhw * -a0).sum(-1))[
        loops].any()
    _, want = _value_and_grad(jcfg, arrays, params)
    model = _model("gat-cora", params).requires_grad_(True)
    lyr = model.params["layers"][0]
    with torch.no_grad():
        hw = (torch.from_numpy(arrays["node_feats"]) @ lyr["w"]).reshape(
            N_NODES, *lyr["a_src"].shape)
        x = (hw * lyr["a_src"]).sum(-1) + (hw * lyr["a_dst"]).sum(-1)
    assert not x[loops].any()
    gnn_loss(model.params, cfg, graph_batch_from_arrays(
        arrays, device="cpu")).backward()
    got = _leaves(gnn_arrays_from_model(model, grad=True))
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= GRAD_TOL * np.abs(w).max(), k
