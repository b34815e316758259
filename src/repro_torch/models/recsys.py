"""DIN (Deep Interest Network) and the EmbeddingBag substrate, the
reference's ``models/recsys.py`` in PyTorch.

``embedding_bag`` is a gather of table rows (``index_select`` of the
clipped ids) and a segment sum of the rows by bag through
:func:`~repro_torch.kernels.segment_spmm.ops.segment_spmm_ad`: on a CUDA
tensor the "sum" kernel (its backward "sum_bwd"), on a CPU tensor the
plain version.  DIN's bags are regular (``n_uf`` ids a user), so their
plan is :func:`~repro_torch.kernels.segment_spmm.ops.bag_plan`, built in
closed form and cached: a serving call waits for nothing.

Every gather of a table that needs a gradient is :class:`TableGather`,
whose backward sums the row gradients by id through ``segment_spmm``
over the touched rows only and writes the sums into the zero table
gradient: no atomics, so a training step replays bit for bit (autograd's
``index_select`` backward, ``index_add_``, does not).  The sums are in
float32, rounded once to the table's dtype.

DIN: target attention over the user behavior sequence (attn MLP 80-40,
not softmax-normalised), then MLP 200-80 -> CTR logit.
``retrieval_scores`` scores users against N candidates with one matrix
product.  The masked sums over the history and that product are plain
``torch``, as the reference leaves them to XLA.

Parameters are a dict in the reference's layout: ``item_table``,
``cate_table``, ``user_table`` (V, d), and ``attn`` and ``mlp``, lists of
``{w (in, out), b (out,)}``.  :class:`DINModel` holds them as
``nn.Parameter``s named ``item_table``, ``attn.0.w``, ... for the
``Trainer``: AdamW's default rule (decay where ``ndim >= 2``) is then
the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.kernels.segment_spmm.ops import SegmentPlan
from repro_torch.models.gnn import DTYPES, ParamTree, _mlp, _mlp_init
from repro_torch.models.layers import _init


# --------------------------------------------------------------------------- #
# table gathers and EmbeddingBag
# --------------------------------------------------------------------------- #
class TableGather(torch.autograd.Function):
    """``table.index_select(0, ids)``, differentiable in ``table``: the
    gradient is the sum of the row gradients by id, taken over the
    distinct ids (``torch.unique``) by ``segment_spmm`` in float32 and
    written into a zero ``(V, d)`` gradient with ``index_copy_``."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, d_rows):
        ids, = ctx.saved_tensors
        uniq, inverse = torch.unique(ids, return_inverse=True)
        n = uniq.numel()
        sums = spmm_ops.segment_spmm(d_rows.contiguous(), inverse, n,
                                     spmm_ops.segment_plan(inverse, n),
                                     out_dtype=ctx.table_dtype)
        grad = d_rows.new_zeros(ctx.table_shape, dtype=ctx.table_dtype)
        return grad.index_copy_(0, uniq.long(), sums), None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table`` rows at ``ids`` (K,): through :class:`TableGather` when
    the table needs a gradient, else a plain ``index_select``."""
    if torch.is_grad_enabled() and table.requires_grad:
        return TableGather.apply(table, ids)
    return table.index_select(0, ids)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  segment_ids: torch.Tensor, n_segments: int,
                  weights: torch.Tensor | None = None, mode: str = "sum",
                  plan: SegmentPlan | None = None) -> torch.Tensor:
    """table (V, d); ids (K,) flat indices, clipped to ``[0, V)``;
    segment_ids (K,) bag assignment -> (n_segments, d) in the table's
    dtype, each bag's rows (times ``weights`` (K,), where given) summed in
    float32.  ``mean`` divides by the bag sizes, floored at 1.  ``plan``
    is ``segment_plan(segment_ids, n_segments)`` (for regular bags
    ``bag_plan``), built here when it is not given."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag mode is sum or mean, not {mode!r}")
    if plan is None:
        plan = spmm_ops.segment_plan(segment_ids, n_segments)
    rows = gather_rows(table, ids.clamp(0, table.shape[0] - 1))
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    out = spmm_ops.segment_spmm_ad(rows, segment_ids, n_segments, plan,
                                   out_dtype=rows.dtype)
    if mode == "mean":
        cnt = (plan.rowptr[1:] - plan.rowptr[:-1]).clamp_min(1)
        out = out / cnt[:, None].to(out.dtype)
    return out


# --------------------------------------------------------------------------- #
# DIN
# --------------------------------------------------------------------------- #
@dataclass
class DINBatch:
    user_feats: torch.Tensor    # (B, n_uf) multi-hot user profile ids
    target_item: torch.Tensor   # (B,)
    target_cate: torch.Tensor   # (B,)
    hist_items: torch.Tensor    # (B, T)
    hist_cates: torch.Tensor    # (B, T)
    hist_mask: torch.Tensor     # (B, T) bool
    labels: torch.Tensor        # (B,) float 0/1

    @classmethod
    def from_arrays(cls, d: dict, device=None) -> "DINBatch":
        """A batch from ``din_batch_stream``'s dict of numpy arrays."""
        device = resolve_device(device)
        return cls(**{f.name: torch.as_tensor(np.asarray(d[f.name]),
                                              device=device)
                      for f in fields(cls)})

    def to(self, device) -> "DINBatch":
        return DINBatch(**{f.name: getattr(self, f.name).to(device)
                           for f in fields(self)})


def init_din(gen: torch.Generator, cfg: RecsysConfig, device=None) -> dict:
    """Seeded parameters: the tables N(0, 0.01²), the MLPs' weights
    N(0, 1/fan_in) and zero biases, drawn from ``gen`` on ``device``; on
    ``device="meta"`` the shapes alone, and ``gen`` may be None."""
    device = resolve_device(device)
    dt, d = DTYPES[cfg.dtype], cfg.embed_dim
    de = 2 * d                         # item+cate concat
    return dict(
        item_table=_init(gen, (cfg.n_items, d), scale=0.01, dtype=dt,
                         device=device),
        cate_table=_init(gen, (cfg.n_cates, d), scale=0.01, dtype=dt,
                         device=device),
        user_table=_init(gen, (cfg.n_user_feats, d), scale=0.01, dtype=dt,
                         device=device),
        attn=_mlp_init(gen, (4 * de, *cfg.attn_mlp, 1), dt, device),
        mlp=_mlp_init(gen, (d + 3 * de, *cfg.mlp, 1), dt, device),
    )


def _embed(params: dict, items: torch.Tensor,
           cates: torch.Tensor) -> torch.Tensor:
    """[item_table[items], cate_table[cates]] (..., 2d)."""
    rows = [gather_rows(params[name], ids.reshape(-1))
            for name, ids in (("item_table", items), ("cate_table", cates))]
    return torch.cat(rows, -1).reshape(*items.shape, -1)


def _user_bag(params: dict, batch: DINBatch) -> torch.Tensor:
    """The user profile: an EmbeddingBag (sum) over the multi-hot ids."""
    B, nuf = batch.user_feats.shape
    plan = spmm_ops.bag_plan(B, nuf, batch.user_feats.device)
    return embedding_bag(params["user_table"], batch.user_feats.reshape(-1),
                         plan.dst, B, mode="sum", plan=plan)


def din_user_state(params: dict, cfg: RecsysConfig, batch: DINBatch):
    """Everything before the target interaction — reusable for retrieval:
    the user bag (B, d) and the history's embeddings (B, T, 2d)."""
    return (_user_bag(params, batch),
            _embed(params, batch.hist_items, batch.hist_cates))


def din_logits(params: dict, cfg: RecsysConfig,
               batch: DINBatch) -> torch.Tensor:
    """The CTR logits (B,): the user bag, the target's embedding, the
    target-attention summary of the history and its masked sum, through
    the MLP."""
    T = batch.hist_items.shape[1]
    u = _user_bag(params, batch)
    # the history and the target in one gather per table
    both = _embed(params,
                  torch.cat([batch.hist_items, batch.target_item[:, None]], 1),
                  torch.cat([batch.hist_cates, batch.target_cate[:, None]], 1))
    hist, tgt = both[:, :T], both[:, T]                     # (B,T,2d), (B,2d)
    # target attention (DIN): MLP on [h, t, h-t, h*t], NOT softmax-normalized
    t_b = tgt[:, None, :].expand_as(hist)
    att_in = torch.cat([hist, t_b, hist - t_b, hist * t_b], -1)
    w = _mlp(params["attn"], att_in)[..., 0]                # (B, T)
    w = torch.where(batch.hist_mask, w, torch.zeros((), dtype=w.dtype,
                                                    device=w.device))
    summary = (w[..., None] * hist).sum(1)                  # (B, 2d)
    hist_sum = (batch.hist_mask[..., None] * hist).sum(1)
    feats = torch.cat([u, tgt, summary, hist_sum], -1)
    return _mlp(params["mlp"], feats)[:, 0]


def din_loss(params: dict, cfg: RecsysConfig,
             batch: DINBatch) -> torch.Tensor:
    """Mean binary cross-entropy of the logits, in the stable softplus
    form, in float32."""
    logit = din_logits(params, cfg, batch).float()
    y = batch.labels.float()
    return torch.mean(torch.clamp_min(logit, 0) - logit * y
                      + torch.log1p(torch.exp(-logit.abs())))


def retrieval_scores(params: dict, cfg: RecsysConfig, batch: DINBatch,
                     cand_items: torch.Tensor,
                     cand_cates: torch.Tensor) -> torch.Tensor:
    """Score batch.user (typically B=1) against N candidates in one
    matrix product: user tower = attention-free summary; item tower =
    embed concat.  (B, N)."""
    u, hist = din_user_state(params, cfg, batch)
    hist_sum = (batch.hist_mask[..., None] * hist).sum(1)   # (B, 2d)
    user_vec = torch.cat([u, hist_sum], -1)                 # (B, 3d)
    cand = _embed(params, cand_items, cand_cates)           # (N, 2d)
    proj = user_vec[:, :cand.shape[-1]]                     # (B, 2d)
    return proj @ cand.T


class DINModel(ParamTree):
    """A DIN of ``cfg`` holding its parameters (as :func:`init_din` or
    ``convert.din_params_from_arrays`` give them) as frozen parameters
    named as the reference's tree (``item_table``, ``attn.0.w``, ...);
    ``forward`` is :func:`din_logits` and :meth:`loss` :func:`din_loss`.
    The ``Trainer`` turns the gradients on."""

    def __init__(self, cfg: RecsysConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg

    @property
    def params(self) -> dict:
        return self.tree()

    def forward(self, batch: DINBatch) -> torch.Tensor:
        return din_logits(self.params, self.cfg, batch)

    def loss(self, batch: DINBatch) -> torch.Tensor:
        return din_loss(self.params, self.cfg, batch)
