"""The port's GNN forward against the reference: reduced GraphCast,
SchNet, PNA and GAT, with the reference's parameters from
``init_gnn(PRNGKey(0))`` carried across by ``gnn_params_from_arrays``,
on one seeded graph (40 nodes, 160 edge slots, 10% masked).
``gnn_forward`` is held to a relative 1e-4 in float32 and 5e-2 in
bfloat16 (max |port - reference| over max |reference|), GAT also with
``gnn_bf16_msgs`` and on two more graphs (a hub above the kernel's
threshold, a node whose every in-edge slot is masked).  In bfloat16 the
port sums messages in float32, as the TPU kernel does, where the
reference's XLA CPU scatter sums in bfloat16: the two agree at these
graphs' in-degrees.  ``gat_aggregate`` on the CPU is held bit for bit to
the layer body ``gat_forward`` had before it was fused."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.distributed import ctx as jax_ctx
from repro.models.gnn import GraphBatch as JaxGraphBatch
from repro.models.gnn import gnn_forward as jax_forward
from repro.models.gnn import init_gnn as jax_init

from _gnn_cases import (ALL_MASKED_NODE, D_FEAT, GAT_GRAPHS, GNN_ARCHS,
                        HUB_NODE, N_OUT, gat_graph_arrays, graph_arrays)
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import gnn_params_from_arrays, graph_batch_from_arrays
from repro_torch.distributed import ctx
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.models import GraphBatch, gnn_forward, init_gnn

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _both(arch: str, dtype: str, bf16_msgs: bool = False, arrays=None):
    """(port output, reference output) of one forward, on ``arrays`` (by
    default the model's seeded graph)."""
    jcfg = dataclasses.replace(jax_reduced(arch), dtype=dtype)
    cfg = dataclasses.replace(get_reduced(arch), dtype=dtype)
    params = jax_init(jax.random.PRNGKey(0), jcfg, D_FEAT, N_OUT)
    tparams = gnn_params_from_arrays(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    if arrays is None:
        arrays = graph_arrays(cfg.kind)
    jgb = JaxGraphBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    gb = graph_batch_from_arrays(arrays, device="cpu")
    jax_ctx.set_flags(gnn_bf16_msgs=bf16_msgs)
    ctx.set_flags(gnn_bf16_msgs=bf16_msgs)
    try:
        want = jax.jit(lambda p: jax_forward(p, jcfg, jgb))(params)
        got = gnn_forward(tparams, cfg, gb)
    finally:
        jax_ctx.reset()
        ctx.reset()
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_forward_matches_reference(arch, dtype):
    got, want = _both(arch, dtype)
    assert tuple(got.shape) == want.shape
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gat_bf16_msgs_matches_reference(dtype):
    got, want = _both("gat-cora", dtype, bf16_msgs=True)
    assert _rel(got, want) <= TOL["bfloat16"]


@pytest.mark.parametrize("dtype,bf16_msgs", [("float32", False),
                                             ("bfloat16", False),
                                             ("float32", True),
                                             ("bfloat16", True)])
@pytest.mark.parametrize("case", GAT_GRAPHS)
def test_gat_graphs_match_reference(case, dtype, bf16_msgs):
    arrays = gat_graph_arrays(case)
    got, want = _both("gat-cora", dtype, bf16_msgs, arrays)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= TOL["bfloat16" if bf16_msgs else dtype]
    deg = np.bincount(arrays["edge_dst"], minlength=len(arrays["node_feats"]))
    if case == "hub":
        assert deg[HUB_NODE] > spmm_ops.HUB_DEGREE
    else:
        assert deg[ALL_MASKED_NODE] > 0 and not arrays["edge_mask"][
            arrays["edge_dst"] == ALL_MASKED_NODE].any()


def _gat_layer_before(hw, s_src, s_dst, gb, acc_dt):
    """One layer of ``gat_forward`` as it was before ``gat_aggregate``:
    the oracle of the plain version's bit-for-bit check."""
    import torch.nn.functional as F
    N, dt = gb.n_nodes, hw.dtype
    src, dst, plan = gb.edge_src, gb.edge_dst, gb.plan()
    dropped = ~gb.edge_mask[:, None]
    score = F.leaky_relu(s_src.index_select(0, src)
                         + s_dst.index_select(0, dst), 0.2).float()
    score.masked_fill_(dropped, -math.inf)
    index = gb.dst_index().view(-1, 1).expand_as(score)
    smax = torch.full((N, score.shape[1]), -math.inf).scatter_reduce_(
        0, index, score, "amax", include_self=False)
    ex = torch.exp(score.sub_(smax.index_select(0, dst))).to(acc_dt)
    ex.masked_fill_(dropped, 0)
    den = spmm_ops.segment_spmm(ex, dst, N, plan, out_dtype=ex.dtype)
    alpha = (ex.float()
             / torch.clamp_min(den.float().index_select(0, dst), 1e-9)
             ).to(dt)
    msg = (alpha[..., None] * hw.index_select(0, src)).to(acc_dt)
    return spmm_ops.segment_spmm(msg, dst, N, plan, out_dtype=msg.dtype)


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["seeded"] + GAT_GRAPHS)
def test_gat_aggregate_plain_is_the_layer_before(case, dtype, acc):
    """On the CPU ``gat_aggregate`` runs ``gat_aggregate_plain``, which
    gives what the layer body gave before, bit for bit, at the full
    config's first-layer heads (8 of 8)."""
    arrays = graph_arrays("gat") if case == "seeded" else gat_graph_arrays(
        case)
    gb = graph_batch_from_arrays(arrays, device="cpu")
    rng = np.random.default_rng(3)
    N, dt, acc_dt = gb.n_nodes, getattr(torch, dtype), getattr(torch, acc)
    hw = torch.from_numpy(rng.normal(size=(N, 8, 8)).astype(np.float32))
    s_src, s_dst = (torch.from_numpy(rng.normal(size=(N, 8)).astype(
        np.float32)).to(dt) for _ in range(2))
    hw = hw.to(dt)
    want = _gat_layer_before(hw, s_src, s_dst, gb, acc_dt)
    args = (hw, s_src, s_dst, gb.gat_plan(), gb.edge_mask, acc_dt)
    got = spmm_ops.gat_aggregate(*args)
    assert got.dtype == acc_dt and got.shape == (N, 8, 8)
    assert torch.equal(got, want)
    assert torch.equal(spmm_ops.gat_aggregate_plain(*args), want)
    if case == "all_masked":
        assert not got[ALL_MASKED_NODE].any()


@pytest.mark.parametrize("arch", [*GNN_ARCHS, "deepseek-v3-671b", "din"])
def test_registry_matches_reference(arch):
    assert (dataclasses.asdict(get_config(arch).model)
            == dataclasses.asdict(jax_config(arch).model))
    assert (dataclasses.asdict(get_reduced(arch))
            == dataclasses.asdict(jax_reduced(arch)))
    assert ([dataclasses.asdict(s) for s in get_config(arch).shapes]
            == [dataclasses.asdict(s) for s in jax_config(arch).shapes])


def test_unported_archs_raise():
    """Every architecture of the reference's registry is ported, and an
    id it does not know raises."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.configs import _NOT_PORTED, ARCH_IDS
    assert not _NOT_PORTED and sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_plan_built_once_per_batch():
    """Every segment sum of a forward reuses the batch's plan; replacing
    ``edge_dst`` builds a new one."""
    cfg = dataclasses.replace(get_reduced("pna"), dtype="float32")
    gb = graph_batch_from_arrays(graph_arrays("pna"), device="cpu")
    params = init_gnn(torch.Generator().manual_seed(0), cfg, D_FEAT, N_OUT,
                      device="cpu")
    plan = gb.plan()
    gnn_forward(params, cfg, gb)
    assert gb.plan() is plan and gb.dst_index().dtype == torch.int64
    gb.edge_dst = gb.edge_dst.flip(0)
    assert gb.plan() is not plan
    torch.testing.assert_close(gb.plan().perm,
                               torch.argsort(gb.edge_dst, stable=True).int())
    assert gb.plan().src is None and "gat_plan" not in gb._memo
    for field in ("edge_src", "edge_mask"):      # GAT's plan holds both
        plan = gb.gat_plan()
        assert gb.gat_plan() is plan
        setattr(gb, field, getattr(gb, field).flip(0))
        assert gb.gat_plan() is not plan
        assert gb.gat_plan().src is gb.edge_src
        assert gb.gat_plan().mask is gb.edge_mask


def test_gat_forward_builds_no_int64_ids():
    """GAT's forward needs its plan, and neither the other models'
    plan nor an int64 copy of ``edge_dst`` (at ogbn-products' size 495
    MB)."""
    cfg = dataclasses.replace(get_reduced("gat-cora"), dtype="float32")
    gb = graph_batch_from_arrays(graph_arrays("gat"), device="cpu")
    params = init_gnn(torch.Generator().manual_seed(0), cfg, D_FEAT, N_OUT,
                      device="cpu")
    gnn_forward(params, cfg, gb)
    assert "gat_plan" in gb._memo
    assert "plan" not in gb._memo and "dst64" not in gb._memo


def test_graph_batch_and_params_from_arrays():
    arrays = graph_arrays("schnet")
    gb = graph_batch_from_arrays(arrays, device="cpu")
    assert isinstance(gb, GraphBatch) and gb.graph_id is None
    assert gb.edge_src.dtype == gb.edge_dst.dtype == torch.int32
    assert gb.edge_mask.dtype == torch.bool and gb.n_nodes == arrays[
        "node_feats"].shape[0]
    cfg = get_reduced("graphcast")
    params = jax_init(jax.random.PRNGKey(0), jax_reduced("graphcast"),
                      D_FEAT, N_OUT)
    tree = jax.tree.map(np.asarray, params)
    tp = gnn_params_from_arrays(tree, cfg, device="cpu")
    assert len(tp["layers"]) == cfg.n_layers
    np.testing.assert_array_equal(
        tp["layers"][1]["edge_mlp"][0]["w"].float().numpy(),
        np.asarray(tree["layers"]["edge_mlp"][0]["w"][1], np.float32))
    with pytest.raises(ValueError):
        gnn_params_from_arrays(tree, dataclasses.replace(cfg, n_layers=3),
                               device="cpu")


def test_ctx_gnn_flags():
    try:
        ctx.set_flags(gnn_bf16_msgs=True, gnn_replicate_nodes=True)
        assert ctx.CURRENT.gnn_bf16_msgs and ctx.CURRENT.gnn_replicate_nodes
    finally:
        ctx.reset()
    assert not ctx.CURRENT.gnn_bf16_msgs
    assert not ctx.CURRENT.gnn_replicate_nodes
