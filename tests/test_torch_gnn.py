"""The port's GNN forward against the reference: reduced GraphCast,
SchNet, PNA and GAT, with the reference's parameters from
``init_gnn(PRNGKey(0))`` carried across by ``gnn_params_from_arrays``,
on one seeded graph (40 nodes, 160 edge slots, 10% masked).
``gnn_forward`` is held to a relative 1e-4 in float32 and 5e-2 in
bfloat16 (max |port - reference| over max |reference|), GAT also with
``gnn_bf16_msgs``.  In bfloat16 the port sums messages in float32, as
the TPU kernel does, where the reference's XLA CPU scatter sums in
bfloat16: the two agree at this graph's small in-degree."""
import dataclasses

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

from _gnn_cases import D_FEAT, GNN_ARCHS, N_OUT, graph_arrays
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import gnn_params_from_arrays, graph_batch_from_arrays
from repro_torch.distributed import ctx
from repro_torch.models import GraphBatch, gnn_forward, init_gnn

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _both(arch: str, dtype: str, bf16_msgs: bool = False):
    """(port output, reference output) of one forward."""
    jcfg = dataclasses.replace(jax_reduced(arch), dtype=dtype)
    cfg = dataclasses.replace(get_reduced(arch), dtype=dtype)
    params = jax_init(jax.random.PRNGKey(0), jcfg, D_FEAT, N_OUT)
    tparams = gnn_params_from_arrays(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
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


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_registry_matches_reference(arch):
    assert (dataclasses.asdict(get_config(arch).model)
            == dataclasses.asdict(jax_config(arch).model))
    assert (dataclasses.asdict(get_reduced(arch))
            == dataclasses.asdict(jax_reduced(arch)))
    assert ([dataclasses.asdict(s) for s in get_config(arch).shapes]
            == [dataclasses.asdict(s) for s in jax_config(arch).shapes])


@pytest.mark.parametrize("arch,item", [("din", "item 12"),
                                       ("deepseek-v3-671b", "item 11")])
def test_unported_archs_raise(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        get_config(arch)


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
