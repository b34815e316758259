"""Carry state from the reference package into the port.

Graphs, partitions, cache states, GNN batches and model weights: a parity
test builds
them once and hands the same numbers to both packages.  These functions
take plain numpy arrays (the reference's fields or parameter pytree, read
with ``np.asarray``), so the port needs nothing of the reference to use
them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig, RecsysConfig, TransformerConfig
from repro_torch.core.cache import AdjCache
from repro_torch.device import resolve_device
from repro_torch.graph.storage import PartitionedGraph

_PG_INTS = ("n", "n_real", "ndev", "stride", "max_degree")
_PG_ARRAYS = ("adj", "deg", "n_local", "border", "border_dist", "old2new",
              "new2old")


def partitioned_from_arrays(d: dict) -> PartitionedGraph:
    """The port's :class:`PartitionedGraph` from a dict of the reference's
    fields (``n, n_real, ndev, stride, max_degree, adj, deg, n_local,
    border, border_dist, old2new, new2old``)."""
    return PartitionedGraph(**{k: int(d[k]) for k in _PG_INTS},
                            **{k: np.array(d[k]) for k in _PG_ARRAYS})


def cache_from_arrays(d: dict, device=None, decay: int = 0) -> AdjCache:
    """An :class:`AdjCache` from ``keys (ndev, slots, ways)``, ``rows
    (ndev, slots, ways, line_width)``, ``benefit`` and ``tick`` arrays
    plus the sentinel ``n``; ``decay`` is the benefit decay period."""
    device = resolve_device(device)
    t = {k: torch.as_tensor(np.asarray(d[k], dtype=np.int32), device=device)
         for k in ("keys", "rows", "benefit", "tick")}
    ndev, slots, ways, line_width = t["rows"].shape
    return AdjCache(ndev=ndev, slots=slots, ways=ways, n=int(d["n"]),
                    line_width=line_width, decay=decay, **t)


def tensor_from_array(a, device: torch.device) -> torch.Tensor:
    """A tensor with ``a``'s values and dtype.  numpy's view of a JAX
    bfloat16 array (``ml_dtypes.bfloat16``) is not a dtype torch reads:
    it goes through float32, which holds every bfloat16 exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_arrays(tree: dict, cfg: TransformerConfig, device=None):
    """The port's :class:`~repro_torch.models.TransformerLM` from the
    reference's parameter pytree as numpy arrays
    (``jax.tree.map(np.asarray, params)``): ``embed``, ``final_norm``,
    ``lm_head`` (untied), ``dense_stack`` / ``moe_stack``, each a dict of
    per-layer weights (GQA or MLA ``attn``) stacked on axis 0 (or None),
    and ``mtp`` (``block``, one unstacked dense layer; ``proj``; ``norm``)
    where the config has an MTP head."""
    from repro_torch.models.transformer import Block, MTPHead, TransformerLM
    device = resolve_device(device)

    def block(arrays: dict, pick, moe: bool):
        """A Block from one layer's arrays, each taken by ``pick``."""
        return Block({k: pick(v) for k, v in arrays["attn"].items()},
                     {k: pick(v) for k, v in arrays["ffn"].items()},
                     pick(arrays["ln1"]), pick(arrays["ln2"]), moe)

    def whole(a):
        return tensor_from_array(a, device)

    blocks = []
    for key, moe in (("dense_stack", False), ("moe_stack", True)):
        stack = tree.get(key)
        if stack is None:
            continue
        for i in range(np.asarray(stack["ln1"]).shape[0]):
            blocks.append(block(stack, lambda a: whole(np.asarray(a)[i]),
                                moe))
    mtp = None
    if tree.get("mtp") is not None:
        m = tree["mtp"]
        mtp = MTPHead(block(m["block"], whole, False), whole(m["proj"]),
                      whole(m["norm"]))
    head = tree.get("lm_head")
    return TransformerLM(
        cfg, tensor_from_array(tree["embed"], device), blocks,
        tensor_from_array(tree["final_norm"], device),
        None if head is None else tensor_from_array(head, device), mtp)


def _array(t: torch.Tensor, grad: bool):
    """``t`` (or its gradient) as a float32 numpy array; a missing
    gradient reads as zeros."""
    if grad:
        t = torch.zeros_like(t) if t.grad is None else t.grad
    return t.detach().float().cpu().numpy()


def lm_arrays_from_model(model, grad: bool = False) -> dict:
    """The inverse of :func:`lm_params_from_arrays`: the reference's
    parameter tree as float32 numpy arrays (``embed``, ``final_norm``,
    ``lm_head`` when untied, ``dense_stack`` and ``moe_stack``, each a
    dict of per-layer weights stacked on axis 0, or None, and ``mtp``
    when the model has an MTP head), from the model's parameters or, with
    ``grad``, from their ``.grad``; so a test can hold parameters and
    gradients against the reference's leaf by leaf."""
    def layer(b) -> dict:
        return dict(attn={n: _array(t, grad) for n, t in b.attn.items()},
                    ffn={n: _array(t, grad) for n, t in b.ffn.items()},
                    ln1=_array(b.ln1, grad), ln2=_array(b.ln2, grad))

    def stack(blocks):
        return _stack([layer(b) for b in blocks]) if blocks else None

    tree = dict(embed=_array(model.embed, grad),
                dense_stack=stack([b for b in model.blocks if not b.moe]),
                moe_stack=stack([b for b in model.blocks if b.moe]),
                final_norm=_array(model.final_norm, grad))
    if model.lm_head is not None:
        tree["lm_head"] = _array(model.lm_head, grad)
    if model.mtp is not None:
        tree["mtp"] = dict(block=layer(model.mtp.block),
                           proj=_array(model.mtp.proj, grad),
                           norm=_array(model.mtp.norm, grad))
    return tree


def _tensors(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device) for v in tree]
    return tensor_from_array(tree, device)


def _layer_of(tree, i: int):
    """Layer ``i`` of a tree whose arrays are stacked on axis 0."""
    if isinstance(tree, dict):
        return {k: _layer_of(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_layer_of(v, i) for v in tree]
    return np.asarray(tree)[i]


def _n_stacked(tree) -> int:
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return np.asarray(tree).shape[0]


def gnn_params_from_arrays(tree: dict, cfg: GNNConfig, device=None) -> dict:
    """The port's GNN parameters from the reference's parameter pytree as
    numpy arrays (``jax.tree.map(np.asarray, params)``).  GraphCast,
    SchNet and PNA stack their per-layer weights on axis 0 for
    ``lax.scan`` (``layers`` is a dict of stacked arrays and lists of
    ``{w, b}``); the port keeps a list of per-layer dicts, as GAT's
    ``layers`` already is.  The dict builds a trainable model:
    ``GNNModel(cfg, params)``."""
    device = resolve_device(device)
    out = {}
    for key, sub in tree.items():
        if key == "layers":
            n = len(sub) if isinstance(sub, list) else _n_stacked(sub)
            if n != cfg.n_layers:
                raise ValueError(f"{cfg.name}: {n} layers in the tree, "
                                 f"{cfg.n_layers} in the config")
            if isinstance(sub, dict):
                sub = [_layer_of(sub, i) for i in range(n)]
        out[key] = _tensors(sub, device)
    return out


def _arrays(tree, grad: bool):
    """A nested dict/list of parameters (or, with ``grad``, their
    gradients) as float32 numpy arrays."""
    if isinstance(tree, dict):
        return {k: _arrays(v, grad) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_arrays(v, grad) for v in tree]
    return _array(tree, grad)


def _stack(trees: list):
    """Per-layer trees of numpy arrays -> one tree stacked on axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_stack([t[i] for t in trees]) for i in range(len(trees[0]))]
    return np.stack(trees)


def gnn_arrays_from_model(model, grad: bool = False) -> dict:
    """The inverse of :func:`gnn_params_from_arrays`: the reference's
    parameter tree as float32 numpy arrays, from a
    :class:`~repro_torch.models.gnn.GNNModel`'s parameters or, with
    ``grad``, their ``.grad``, with ``layers`` stacked on axis 0 where
    the reference stacks them (GraphCast, SchNet, PNA); so a test can
    hold parameters and gradients against the reference's leaf by
    leaf."""
    from repro_torch.models.gnn import STACKED_KINDS
    out = _arrays(model.params, grad)
    if model.cfg.kind in STACKED_KINDS:
        out["layers"] = _stack(out["layers"])
    return out


def din_params_from_arrays(tree: dict, cfg: RecsysConfig, device=None) -> dict:
    """The port's DIN parameters from the reference's parameter pytree as
    numpy arrays (``jax.tree.map(np.asarray, init_din(...))``): the same
    layout, ``item_table``, ``cate_table``, ``user_table`` and the
    ``attn`` and ``mlp`` lists of ``{w, b}``, as tensors.  The dict
    builds a trainable model: ``DINModel(cfg, params)``."""
    d = cfg.embed_dim
    want = {"item_table": (cfg.n_items, d), "cate_table": (cfg.n_cates, d),
            "user_table": (cfg.n_user_feats, d)}
    for key, shape in want.items():
        if np.shape(tree[key]) != shape:
            raise ValueError(f"{cfg.name}: {key} {np.shape(tree[key])} in "
                             f"the tree, {shape} in the config")
    return _tensors({k: tree[k] for k in (*want, "attn", "mlp")},
                    resolve_device(device))


def din_arrays_from_model(model, grad: bool = False) -> dict:
    """The inverse of :func:`din_params_from_arrays`: the reference's
    parameter tree as float32 numpy arrays, from a
    :class:`~repro_torch.models.recsys.DINModel`'s parameters or, with
    ``grad``, their ``.grad``."""
    return _arrays(model.params, grad)


_GB_FIELDS = {"node_feats": None, "edge_src": np.int32, "edge_dst": np.int32,
              "edge_mask": bool, "labels": None, "label_mask": bool,
              "positions": None, "graph_id": np.int32}


def graph_batch_from_arrays(d: dict, device=None):
    """The port's :class:`~repro_torch.models.gnn.GraphBatch` from a dict
    of the reference's fields as numpy arrays (``node_feats``,
    ``edge_src``, ``edge_dst``, ``edge_mask``; ``labels``,
    ``label_mask``, ``positions`` and ``graph_id`` where present): ids as
    int32, masks as bool, features in their own dtype."""
    from repro_torch.models.gnn import GraphBatch
    device = resolve_device(device)
    kw = {}
    for key, dtype in _GB_FIELDS.items():
        if d.get(key) is not None:
            a = np.asarray(d[key]) if dtype is None else np.asarray(d[key],
                                                                     dtype)
            kw[key] = tensor_from_array(a, device)
    return GraphBatch(**kw)
