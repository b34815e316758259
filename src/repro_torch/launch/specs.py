"""Per-(arch x shape) cells of the production plan: the reference's
``launch/specs.py`` for the port.

``build_cell(arch_id, shape_name, mesh, opt)`` returns a :class:`Cell`:

  fn          — the port's step (AdamW training through ``lm_loss`` /
                ``gnn_loss`` / ``din_loss``, ``prefill``, ``decode_step``,
                the ``din_logits`` sigmoid, ``retrieval_scores``)
  arg_specs   — its arguments at the cell's global shapes and dtypes on
                the ``meta`` device (no storage): the model built shape
                only, AdamW's moments, the inputs.  Two host scalars
                are real 0-d int32 CPU tensors, as the port keeps them:
                AdamW's step count and decode's cache length
  placements  — per argument, leaf name -> :class:`Sharding`
  meta        — the reference's model-flop and size figures, by the
                reference's arithmetic
  roles       — per argument, what it holds: "params", "opt_state",
                "inputs" or "cache"

:meth:`Cell.leaves` walks every argument leaf with its sharding, and
:func:`arg_bytes` sums their shards per device.  The shardings,
paddings and ``variant`` flag sets are the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import get_config
from repro_torch.configs.base import GNNConfig, RecsysConfig, TransformerConfig
from repro_torch.distributed import ctx
from repro_torch.distributed.sharding import (Sharding, axis_size, dp_axes,
                                              data_shardings, dp_entry,
                                              param_shardings, replicated)
from repro_torch.graph.sampler import sample_capacities
from repro_torch.models.gnn import GNNModel, GraphBatch, gnn_loss, init_gnn
from repro_torch.models.recsys import (DINBatch, DINModel, din_logits,
                                       din_loss, init_din, retrieval_scores)
from repro_torch.models.transformer import (cache_spec, decode_step,
                                            init_lm_params, lm_loss, prefill)
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state

F32, BF16, I32, BOOL = torch.float32, torch.bfloat16, torch.int32, torch.bool
META = torch.device("meta")


def _flat(tree, prefix: str = ""):
    """``(name, leaf)`` of a tree of tensors: an ``nn.Module``'s
    parameters by their names, dict keys and list indices joined by '.',
    a dataclass's (non-private, non-None) fields."""
    def join(k):
        return f"{prefix}.{k}" if prefix else str(k)

    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, torch.nn.Module):
        for n, p in tree.named_parameters():
            yield join(n), p
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, join(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, join(i))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if not f.name.startswith("_") and v is not None:
                yield from _flat(v, join(f.name))


def _all(tree, sh: Sharding) -> dict:
    return {n: sh for n, _ in _flat(tree)}


@dataclass
class Cell:
    arch: str
    shape: str
    fn: Callable
    arg_specs: tuple
    placements: tuple
    meta: dict = field(default_factory=dict)
    roles: tuple = ()

    def leaves(self):
        """``(arg_index, name, tensor, sharding)`` of every argument
        leaf; a bare tensor argument's name is ''."""
        for i, (arg, pl) in enumerate(zip(self.arg_specs, self.placements)):
            for name, t in _flat(arg):
                yield i, name, t, pl[name]


ROLES = ("params", "opt_state", "inputs", "cache")


def arg_bytes(cell: Cell) -> dict:
    """Rank 0's bytes of every argument leaf's shard, summed by role and
    in all (``total``).  Runs where the cell's mesh lives (inside its
    :func:`~repro_torch.launch.mesh.plan_world`)."""
    memo: dict = {}
    out = dict.fromkeys(ROLES, 0)
    for i, _, t, sh in cell.leaves():
        local = sh.local_shape(t.shape, t.dtype, memo)
        out[cell.roles[i]] += math.prod(local) * t.element_size()
    out["total"] = sum(out[r] for r in ROLES)
    return out


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _host_int(v: int) -> torch.Tensor:
    return torch.tensor(v, dtype=I32)


def _train_step(loss_fn, opt: AdamWConfig):
    """The Trainer's step on ``model``: gradients of
    ``loss_fn(model, *inputs)`` (a parameter the loss does not reach gets
    a zero gradient) and one AdamW update by the model's decay rule."""
    def train_step(model, opt_state, *inputs):
        params = dict(model.named_parameters())
        loss = loss_fn(model, *inputs)
        gs = torch.autograd.grad(loss, list(params.values()),
                                 allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), gs)}
        decay = (model.decayed_params()
                 if hasattr(model, "decayed_params") else None)
        params, opt_state, info = adamw_update(params, grads, opt_state, opt,
                                               decay)
        return params, opt_state, loss, info["grad_norm"]

    return train_step


# --------------------------------------------------------------------------- #
# LM cells
# --------------------------------------------------------------------------- #
def _lm_model(cfg: TransformerConfig, mesh: DeviceMesh):
    model = init_lm_params(None, cfg, device=META)
    return model, param_shardings(dict(model.named_parameters()), "lm", mesh)


def _lm_train_cell(arch, shape, cfg: TransformerConfig, mesh, opt: AdamWConfig,
                   remat: bool = True):
    model, p_sh = _lm_model(cfg, mesh)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    o_spec = init_opt_state(params, opt)
    o_sh = {**{f"mu.{n}": s for n, s in p_sh.items()},
            **{f"nu.{n}": s for n, s in p_sh.items()},
            "step": replicated(mesh)}
    B, S = shape["global_batch"], shape["seq_len"]
    tok_sh = {"": data_shardings("lm", "train", mesh)(2)}
    train_step = _train_step(
        lambda mdl, tokens, labels: lm_loss(mdl, tokens, labels, remat=remat),
        opt)
    meta = dict(model_flops=6 * cfg.active_param_count() * B * S,
                model_flops_remat=8 * cfg.active_param_count() * B * S,
                tokens=B * S, scan_trip=cfg.n_layers)
    return Cell(arch, shape.name, train_step,
                (model, o_spec, _sds((B, S), I32), _sds((B, S), I32)),
                (p_sh, o_sh, tok_sh, tok_sh), meta,
                ("params", "opt_state", "inputs", "inputs"))


def _attn_flops(cfg: TransformerConfig, B, S, causal=True):
    hd = cfg.head_dim if cfg.mla is None else (
        cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        + cfg.mla.v_head_dim) // 2
    f = 2 * B * cfg.n_heads * S * S * hd * 2  # qk + pv
    return f // 2 if causal else f


def _lm_prefill_cell(arch, shape, cfg, mesh, variant: str = "baseline"):
    model, p_sh = _lm_model(cfg, mesh)
    B, S = shape["global_batch"], shape["seq_len"]
    tok_sh = {"": data_shardings("lm", "prefill", mesh)(2)}
    # the reference's opt variants also compute the last position's
    # logits alone (their cache layout hints have no counterpart here)
    last_only = variant != "baseline"

    def prefill_step(model, tokens):
        logits, cache = prefill(model, tokens, last_only=last_only)
        return logits[:, -1], cache

    meta = dict(model_flops=2 * cfg.active_param_count() * B * S
                + _attn_flops(cfg, B, S), tokens=B * S,
                scan_trip=cfg.n_layers)
    return Cell(arch, shape.name, prefill_step, (model, _sds((B, S), I32)),
                (p_sh, tok_sh), meta, ("params", "inputs"))


def _lm_decode_cell(arch, shape, cfg, mesh, long: bool = False):
    model, p_sh = _lm_model(cfg, mesh)
    B, S = shape["global_batch"], shape["seq_len"]
    dpa = dp_entry(mesh)
    cs = cache_spec(cfg, B, S)
    c_spec = {k: _sds(s, d) for k, (s, d) in cs.shapes.items()}
    if long:
        # batch=1: shard the *sequence* axis of the cache (data axis),
        # model axis left for attention-head/TP sharding of the weights
        c_sh = {k: Sharding(mesh, (None, None, dpa, *([None] * (len(s) - 3))))
                for k, (s, d) in cs.shapes.items()}
        tok_sh = replicated(mesh)
    else:
        # batch over data axes, sequence over model axis
        c_sh = {k: Sharding(mesh, (None, dpa, "model",
                                   *([None] * (len(s) - 3))))
                for k, (s, d) in cs.shapes.items()}
        tok_sh = Sharding(mesh, (dpa,))
    absorbed = cfg.mla is not None

    def serve_step(model, cache, tokens, length):
        return decode_step(model, cache, tokens, int(length),
                           absorbed=absorbed)

    kv_bytes = sum(int(np.prod(s)) * 2 for s, _ in cs.shapes.values())
    meta = dict(model_flops=2 * cfg.active_param_count() * B
                + 2 * B * kv_bytes,   # decode reads the whole cache
                kv_cache_bytes=kv_bytes, tokens=B, scan_trip=cfg.n_layers)
    # the step writes the last slot and attends over the full cache
    return Cell(arch, shape.name, serve_step,
                (model, c_spec, _sds((B,), I32), _host_int(S - 1)),
                (p_sh, c_sh, {"": tok_sh}, {"": replicated(mesh)}), meta,
                ("params", "cache", "inputs", "inputs"))


# --------------------------------------------------------------------------- #
# GNN cells
# --------------------------------------------------------------------------- #
def _gnn_batch_specs(cfg: GNNConfig, N, E, d_feat, mesh):
    dpa = dp_entry(mesh)
    e_sh = Sharding(mesh, (dpa,))
    if ctx.CURRENT.gnn_replicate_nodes:
        # node arrays replicated -> src-feature gathers become local; only
        # the (N, H)-sized aggregation partials reduce
        n_sh = replicated(mesh)
        dpa = None
    else:
        n_sh = Sharding(mesh, (dpa, None))
    if cfg.kind == "graphcast":
        labels = _sds((N, cfg.n_vars), F32)
    elif cfg.kind == "schnet":
        labels = _sds((N,), F32)
    else:
        labels = _sds((N,), I32)
    gb = GraphBatch(
        node_feats=_sds((N, d_feat), BF16),
        edge_src=_sds((E,), I32), edge_dst=_sds((E,), I32),
        edge_mask=_sds((E,), BOOL), labels=labels,
        label_mask=_sds((N,), BOOL),
        positions=_sds((N, 3), F32) if cfg.kind == "schnet" else None)
    gb_sh = dict(
        node_feats=n_sh, edge_src=e_sh, edge_dst=e_sh, edge_mask=e_sh,
        labels=Sharding(mesh, (dpa, None) if cfg.kind == "graphcast"
                        else (dpa,)),
        label_mask=Sharding(mesh, (dpa,)))
    if cfg.kind == "schnet":
        gb_sh["positions"] = n_sh
    return gb, gb_sh


def _dp_total(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in dp_axes(mesh))


def _gnn_cell(arch, shape, cfg: GNNConfig, mesh, opt: AdamWConfig):
    n_out = cfg.n_classes
    if shape.kind == "minibatch":
        N, E = sample_capacities(shape["batch_nodes"],
                                 (shape["fanout0"], shape["fanout1"]))
    elif shape.kind == "batched_graphs":
        N = shape["n_nodes"] * shape["batch"]
        E = shape["n_edges"] * 2 * shape["batch"]
    else:
        N, E = shape["n_nodes"], shape["n_edges"]
    # pad node/edge counts to the DP width (masked padding is already part
    # of the GraphBatch contract — the loaders pad the same way)
    m = _dp_total(mesh)
    N = -(-N // m) * m
    E = -(-E // m) * m
    d_feat = shape.dims.get("d_feat", 16)
    model = GNNModel(cfg, init_gnn(None, cfg, d_feat, n_out, device=META))
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    p_sh = param_shardings(params, "gnn", mesh)
    o_spec = init_opt_state(params, opt)
    o_sh = _all(o_spec, replicated(mesh))
    gb, gb_sh = _gnn_batch_specs(cfg, N, E, d_feat, mesh)
    d = cfg.d_hidden
    meta = dict(model_flops=int(cfg.n_layers * (4 * E * d * d + 8 * N * d * d)),
                n_nodes=N, n_edges=E, scan_trip=cfg.n_layers)
    return Cell(arch, shape.name,
                _train_step(lambda mdl, b: gnn_loss(mdl.params, cfg, b), opt),
                (model, o_spec, gb), (p_sh, o_sh, gb_sh), meta,
                ("params", "opt_state", "inputs"))


# --------------------------------------------------------------------------- #
# RecSys cells
# --------------------------------------------------------------------------- #
def _din_batch_specs(cfg: RecsysConfig, B, mesh):
    if B % _dp_total(mesh) == 0:
        batch0 = data_shardings("recsys", "batch", mesh)
        b1, b2 = batch0(1), batch0(2)
    else:  # tiny batches (retrieval B=1): replicate
        b1 = b2 = replicated(mesh)
    T = cfg.seq_len
    batch = DINBatch(
        user_feats=_sds((B, 4), I32), target_item=_sds((B,), I32),
        target_cate=_sds((B,), I32), hist_items=_sds((B, T), I32),
        hist_cates=_sds((B, T), I32), hist_mask=_sds((B, T), BOOL),
        labels=_sds((B,), F32))
    sh = dict(user_feats=b2, target_item=b1, target_cate=b1,
              hist_items=b2, hist_cates=b2, hist_mask=b2, labels=b1)
    return batch, sh


def _din_mlp_flops(cfg: RecsysConfig) -> int:
    d = cfg.embed_dim
    mlp_f = (4 * 2 * d) * cfg.attn_mlp[0] + cfg.attn_mlp[0] * cfg.attn_mlp[1]
    return cfg.seq_len * mlp_f + (7 * d) * cfg.mlp[0] + cfg.mlp[0] * cfg.mlp[1]


def _din_cell(arch, shape, cfg: RecsysConfig, mesh, opt: AdamWConfig):
    model = DINModel(cfg, init_din(None, cfg, device=META))
    params = dict(model.named_parameters())
    p_sh = param_shardings(params, "recsys", mesh)
    kind = shape.kind
    d = cfg.embed_dim
    if kind == "retrieval":
        B, NC = shape["batch"], shape["n_candidates"]
        all_ax = mesh.size()
        NC = -(-NC // all_ax) * all_ax     # pad candidate set to mesh width
        batch, b_sh = _din_batch_specs(cfg, B, mesh)
        cand_sh = {"": Sharding(mesh, (tuple(mesh.mesh_dim_names),))}

        def retrieval_step(model, batch, cand_items, cand_cates):
            return retrieval_scores(model.params, cfg, batch, cand_items,
                                    cand_cates)

        meta = dict(model_flops=2 * B * NC * 2 * d, candidates=NC)
        return Cell(arch, shape.name, retrieval_step,
                    (model, batch, _sds((NC,), I32), _sds((NC,), I32)),
                    (p_sh, b_sh, cand_sh, cand_sh), meta,
                    ("params", "inputs", "inputs", "inputs"))
    B = shape["batch"]
    batch, b_sh = _din_batch_specs(cfg, B, mesh)
    if kind == "train":
        model.requires_grad_(True)
        o_spec = init_opt_state(params, opt)
        m_sh = param_shardings(o_spec["mu"], "recsys", mesh)
        o_sh = {**{f"mu.{n}": s for n, s in m_sh.items()},
                **{f"nu.{n}": s for n, s in m_sh.items()},
                "step": replicated(mesh)}
        meta = dict(model_flops=6 * B * _din_mlp_flops(cfg))
        return Cell(arch, shape.name,
                    _train_step(lambda mdl, b: din_loss(mdl.params, cfg, b),
                                opt),
                    (model, o_spec, batch), (p_sh, o_sh, b_sh), meta,
                    ("params", "opt_state", "inputs"))

    def serve_step(model, batch):
        return torch.sigmoid(din_logits(model.params, cfg, batch))

    meta = dict(model_flops=2 * B * _din_mlp_flops(cfg))
    return Cell(arch, shape.name, serve_step, (model, batch), (p_sh, b_sh),
                meta, ("params", "inputs"))


# --------------------------------------------------------------------------- #
# entry
# --------------------------------------------------------------------------- #
def _variant_flags(variant: str, mesh: DeviceMesh) -> dict:
    """The reference's ``ctx`` flag set of ``variant``."""
    dpa = dp_entry(mesh)
    if variant == "baseline":
        return {}
    if variant == "opt":
        return dict(dp_axes=dpa, moe_ep_constrain=True, gnn_bf16_msgs=True)
    if variant == "opt2":
        return dict(dp_axes=dpa, moe_tp=True, gnn_bf16_msgs=True,
                    gnn_replicate_nodes=True)
    if variant == "opt3":
        # baseline EP sharding, tighter dispatch capacity
        return dict(dp_axes=dpa, moe_capacity_factor=1.0,
                    gnn_replicate_nodes=True, gnn_bf16_msgs=True)
    raise ValueError(f"unknown variant {variant!r}")


def _with_flags(fn: Callable, flags: dict) -> Callable:
    def step(*args):
        with ctx.scope(**flags):
            return fn(*args)

    return step


def build_cell(arch_id: str, shape_name: str, mesh: DeviceMesh,
               opt: AdamWConfig | None = None, remat: bool = True,
               variant: str = "baseline") -> Cell:
    """variant='baseline' is the paper-faithful configuration; 'opt',
    'opt2' and 'opt3' are the reference's flag sets (``ctx``), which
    select specs here (``moe_tp``: the experts' rule;
    ``gnn_replicate_nodes``: the GNN node arrays) and behaviour in the
    models (``moe_capacity_factor``, ``gnn_bf16_msgs``).  The flag set
    holds while the cell is built and while its ``fn`` runs, and nowhere
    else: the flags in force around either come back after it."""
    flags = _variant_flags(variant, mesh)
    with ctx.scope(**flags):
        cell = _build_cell(arch_id, shape_name, mesh, opt or AdamWConfig(),
                           remat, variant)
    return dataclasses.replace(cell, fn=_with_flags(cell.fn, flags))


def _build_cell(arch_id, shape_name, mesh, opt: AdamWConfig, remat: bool,
                variant: str) -> Cell:
    ac = get_config(arch_id)
    cfg = ac.model
    shape = ac.shape(shape_name)
    if cfg.family == "lm":
        if cfg.name == "deepseek-v3-671b":
            opt = dataclasses.replace(opt, moment_dtype="bfloat16")
        if shape.kind == "train":
            return _lm_train_cell(arch_id, shape, cfg, mesh, opt, remat)
        if shape.kind == "prefill":
            return _lm_prefill_cell(arch_id, shape, cfg, mesh, variant)
        if shape.kind == "decode":
            return _lm_decode_cell(arch_id, shape, cfg, mesh, long=False)
        if shape.kind == "long_decode":
            return _lm_decode_cell(arch_id, shape, cfg, mesh, long=True)
    if cfg.family == "gnn":
        return _gnn_cell(arch_id, shape, cfg, mesh, opt)
    if cfg.family == "recsys":
        return _din_cell(arch_id, shape, cfg, mesh, opt)
    raise KeyError((arch_id, shape_name))
