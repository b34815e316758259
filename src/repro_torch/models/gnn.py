"""The GNN model zoo of the reference's ``models/gnn.py``: GraphCast
(encode-process-decode interaction network), SchNet (continuous-filter
convolution), PNA (multi-aggregator) and GAT (attention), their forward
and their training loss.

Message passing is a gather of node rows along the edges, per-edge
arithmetic, and a segment sum of the messages by destination node.
Every segment sum of GraphCast, SchNet and PNA goes through
:func:`segment_spmm`, and each GAT layer's scores, segment softmax and
sum through :func:`gat_aggregate`: on a CUDA tensor the hand-written
kernel (``kernels.segment_spmm``, its "sum" and "gat" variants), on a
CPU tensor its plain version.  The kernel works from the batch's
destination-sorted CSR plan, which :meth:`GraphBatch.plan` (GAT's:
:meth:`GraphBatch.gat_plan`) builds once per batch and every layer
reuses.  PNA's segment max and min are plain
PyTorch, as the reference leaves them to XLA.

Parameters are nested dicts and lists of tensors.  Where the reference
stacks per-layer weights for ``lax.scan``, the port keeps a list of
per-layer dicts and loops over it.

Training: :func:`gnn_loss` (the reference's) and :class:`GNNModel`, an
``nn.Module`` that holds the parameter tree, for the ``Trainer``.  The
segment sums and GAT's aggregation go through the differentiable entries
(``segment_spmm_ad``, ``gat_aggregate_ad``): on the card their backward
kernels "sum_bwd" and "gat_bwd", on the CPU autograd through the plain
versions.  A forward that asks for no gradient (serving) calls the
kernel wrappers directly, as before.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import ctx
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.kernels.segment_spmm.ops import SegmentPlan, segment_plan
from repro_torch.kernels.segment_spmm.ref import segment_max
from repro_torch.models.layers import _init

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the kinds whose per-layer weights the reference stacks for lax.scan
STACKED_KINDS = ("graphcast", "schnet", "pna")


@dataclass
class GraphBatch:
    """One graph (or a batch of graphs) in the reference's format: edges
    are slots, and a slot whose ``edge_mask`` is False carries no
    message."""

    node_feats: torch.Tensor          # (N, F)
    edge_src: torch.Tensor            # (E,) int32
    edge_dst: torch.Tensor            # (E,) int32
    edge_mask: torch.Tensor           # (E,) bool
    labels: torch.Tensor | None = None       # (N,) int32 or (N, n_vars)
    label_mask: torch.Tensor | None = None   # (N,) bool
    positions: torch.Tensor | None = None    # (N, 3) for schnet
    graph_id: torch.Tensor | None = None     # (N,) for batched molecules
    _memo: dict = field(default_factory=dict, init=False, repr=False,
                        compare=False)

    @property
    def n_nodes(self) -> int:
        return self.node_feats.shape[0]

    def _memoized(self, name: str, build):
        edges = (self.edge_src, self.edge_dst, self.edge_mask)
        key, val = self._memo.get(name, ((None,) * 3, None))
        if any(k is not t for k, t in zip(key, edges)):
            val = build()
            self._memo[name] = (edges, val)
        return val

    def plan(self) -> SegmentPlan:
        """The destination-sorted CSR of the edges, built at first use
        and kept until an edge field is replaced."""
        return self._memoized(
            "plan", lambda: segment_plan(self.edge_dst, self.n_nodes))

    def gat_plan(self) -> SegmentPlan:
        """:meth:`plan` with the edges' sources and mask also in its
        order, which GAT's kernel reads (two more E-sized gathers, so the
        other models do not build it)."""
        return self._memoized("gat_plan", lambda: segment_plan(
            self.edge_dst, self.n_nodes, src=self.edge_src,
            mask=self.edge_mask))

    def gat_source_plan(self) -> SegmentPlan:
        """:func:`~repro_torch.kernels.segment_spmm.ops.source_plan` of
        :meth:`gat_plan`: the edges by source, which GAT's backward
        kernel reads; built at its first use."""
        return self._memoized("gat_source_plan",
                              lambda: spmm_ops.source_plan(self.gat_plan()))

    def dst_index(self) -> torch.Tensor:
        """``edge_dst`` as int64, the index ``scatter_reduce_`` takes,
        converted once per batch."""
        return self._memoized("dst64", lambda: self.edge_dst.long())


def _dt(cfg: GNNConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _mlp_init(gen: torch.Generator, dims, dtype, device) -> list:
    return [dict(w=_init(gen, (dims[i], dims[i + 1]), dtype=dtype,
                         device=device),
                 b=torch.zeros((dims[i + 1],), dtype=dtype, device=device))
            for i in range(len(dims) - 1)]


def _mlp(params: list, x: torch.Tensor, act=F.silu,
         final_act: bool = False) -> torch.Tensor:
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x


def _seg_sum(x: torch.Tensor, idx: torch.Tensor, n: int,
             plan: SegmentPlan | None = None) -> torch.Tensor:
    """Sum of ``x`` (E, ...) by ``idx`` into (n, ...), in x's dtype
    (accumulated in float32); differentiable in ``x``."""
    return spmm_ops.segment_spmm_ad(x, idx, n, plan, out_dtype=x.dtype)


def _seg_mean(x: torch.Tensor, idx: torch.Tensor, n: int,
              mask: torch.Tensor, plan: SegmentPlan | None = None
              ) -> torch.Tensor:
    s = _seg_sum(x, idx, n, plan)
    c = _seg_sum(mask.to(x.dtype)[:, None], idx, n, plan)
    return s / torch.clamp_min(c, 1)


# =========================================================================== #
# GraphCast-style encode-process-decode interaction network
# =========================================================================== #
def init_graphcast(gen: torch.Generator, cfg: GNNConfig, d_feat: int,
                   device=None) -> dict:
    dt, d = _dt(cfg), cfg.d_hidden
    enc_node = _mlp_init(gen, (d_feat, d, d), dt, device)
    enc_edge = _mlp_init(gen, (2 * d, d, d), dt, device)
    layers = [dict(edge_mlp=_mlp_init(gen, (3 * d, d, d), dt, device),
                   node_mlp=_mlp_init(gen, (2 * d, d, d), dt, device))
              for _ in range(cfg.n_layers)]
    dec = _mlp_init(gen, (d, d, cfg.n_vars), dt, device)
    return dict(enc_node=enc_node, enc_edge=enc_edge, layers=layers, dec=dec)


def graphcast_forward(params: dict, cfg: GNNConfig,
                      gb: GraphBatch) -> torch.Tensor:
    N, dt = gb.n_nodes, _dt(cfg)
    src, dst, plan = gb.edge_src, gb.edge_dst, gb.plan()
    h = _mlp(params["enc_node"], gb.node_feats.to(dt))
    e = _mlp(params["enc_edge"],
             torch.cat([h.index_select(0, src), h.index_select(0, dst)], -1))
    m = gb.edge_mask[:, None].to(dt)
    for lyr in params["layers"]:
        e_in = torch.cat([e, h.index_select(0, src), h.index_select(0, dst)],
                         -1)
        e = e + _mlp(lyr["edge_mlp"], e_in) * m
        agg = _seg_sum(e * m, dst, N, plan)
        h = h + _mlp(lyr["node_mlp"], torch.cat([h, agg], -1))
    return _mlp(params["dec"], h)                       # (N, n_vars)


# =========================================================================== #
# SchNet
# =========================================================================== #
def init_schnet(gen: torch.Generator, cfg: GNNConfig, d_feat: int,
                device=None) -> dict:
    dt, d, R = _dt(cfg), cfg.d_hidden, cfg.n_rbf
    emb = _mlp_init(gen, (d_feat, d), dt, device)
    layers = [dict(filt=_mlp_init(gen, (R, d, d), dt, device),
                   w_in=_init(gen, (d, d), dtype=dt, device=device),
                   out=_mlp_init(gen, (d, d, d), dt, device))
              for _ in range(cfg.n_layers)]
    head = _mlp_init(gen, (d, d // 2, 1), dt, device)
    return dict(emb=emb, layers=layers, head=head)


def _rbf(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    centers = torch.linspace(0.0, cutoff, n_rbf, device=dist.device)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * (dist[:, None] - centers) ** 2)


def schnet_forward(params: dict, cfg: GNNConfig,
                   gb: GraphBatch) -> torch.Tensor:
    """Continuous-filter convolution; returns the per-node scalar (N,)."""
    N, dt = gb.n_nodes, _dt(cfg)
    if gb.positions is None:
        raise ValueError("schnet needs positions")
    src, dst, plan, pos = gb.edge_src, gb.edge_dst, gb.plan(), gb.positions
    h = _mlp(params["emb"], gb.node_feats.to(dt))
    dvec = pos.index_select(0, src) - pos.index_select(0, dst)
    dist = torch.sqrt((dvec * dvec).sum(-1) + 1e-12)
    rbf = _rbf(dist, cfg.n_rbf, cfg.cutoff).to(dt)
    # cosine cutoff envelope
    env = 0.5 * (torch.cos(math.pi * torch.clamp(dist / cfg.cutoff, 0, 1))
                 + 1)
    m = ((gb.edge_mask & (dist < cfg.cutoff)).to(dt)[:, None]
         * env[:, None].to(dt))
    for lyr in params["layers"]:
        W = _mlp(lyr["filt"], rbf)                      # (E, d)
        msg = (h @ lyr["w_in"]).index_select(0, src) * W * m
        agg = _seg_sum(msg, dst, N, plan)
        h = h + _mlp(lyr["out"], agg)
    return _mlp(params["head"], h)[:, 0]                # (N,)


# =========================================================================== #
# PNA
# =========================================================================== #
def init_pna(gen: torch.Generator, cfg: GNNConfig, d_feat: int, n_out: int,
             device=None) -> dict:
    dt, d = _dt(cfg), cfg.d_hidden
    n_tow = len(cfg.aggregators) * len(cfg.scalers)
    enc = _mlp_init(gen, (d_feat, d), dt, device)
    layers = [dict(pre=_mlp_init(gen, (2 * d, d), dt, device),
                   post=_mlp_init(gen, (n_tow * d + d, d), dt, device))
              for _ in range(cfg.n_layers)]
    dec = _mlp_init(gen, (d, n_out), dt, device)
    return dict(enc=enc, layers=layers, dec=dec)


def pna_forward(params: dict, cfg: GNNConfig, gb: GraphBatch,
                avg_log_deg: float = 2.0) -> torch.Tensor:
    N, dt = gb.n_nodes, _dt(cfg)
    src, dst, plan = gb.edge_src, gb.edge_dst, gb.plan()
    h = _mlp(params["enc"], gb.node_feats.to(dt))
    mask = gb.edge_mask
    mcol = mask[:, None]
    deg = _seg_sum(mask.float()[:, None], dst, N, plan)[:, 0]
    log_deg = torch.log1p(deg)[:, None].to(dt)
    has_in = deg[:, None] > 0
    for lyr in params["layers"]:
        msg = _mlp(lyr["pre"], torch.cat([h.index_select(0, src),
                                          h.index_select(0, dst)], -1))
        msg = msg * mcol.to(dt)
        aggs = []
        mean = _seg_mean(msg, dst, N, mask, plan)
        for a in cfg.aggregators:
            if a == "mean":
                aggs.append(mean)
            elif a == "max":
                mx = segment_max(torch.where(mcol, msg, -1e9).float(),
                                 gb.dst_index(), N)
                aggs.append(torch.where(has_in, mx, 0).to(dt))
            elif a == "min":
                mn = -segment_max(torch.where(mcol, -msg, -1e9).float(),
                                  gb.dst_index(), N)
                aggs.append(torch.where(has_in, mn, 0).to(dt))
            elif a == "std":
                sq = _seg_mean(msg * msg, dst, N, mask, plan)
                var = torch.clamp_min((sq - mean * mean).float(), 0)
                aggs.append(torch.sqrt(var + 1e-5).to(dt))  # eps: finite grad
        towers = []
        for agg in aggs:
            for s in cfg.scalers:
                if s == "identity":
                    towers.append(agg)
                elif s == "amplification":
                    towers.append(agg * log_deg / avg_log_deg)
                elif s == "attenuation":
                    towers.append(agg * avg_log_deg
                                  / torch.clamp_min(log_deg, 1e-3))
        h = h + _mlp(lyr["post"], torch.cat(towers + [h], -1))
    return _mlp(params["dec"], h)


# =========================================================================== #
# GAT
# =========================================================================== #
def init_gat(gen: torch.Generator, cfg: GNNConfig, d_feat: int, n_out: int,
             device=None) -> dict:
    dt, d, H = _dt(cfg), cfg.d_hidden, cfg.n_heads
    dims_in = [d_feat] + [d * H] * (cfg.n_layers - 1)
    dims_out = [d] * (cfg.n_layers - 1) + [n_out]
    layers = [dict(w=_init(gen, (dims_in[i], H * dims_out[i]), dtype=dt,
                           device=device),
                   a_src=_init(gen, (H, dims_out[i]), dtype=dt, device=device),
                   a_dst=_init(gen, (H, dims_out[i]), dtype=dt, device=device))
              for i in range(cfg.n_layers)]
    return dict(layers=layers)


def gat_forward(params: dict, cfg: GNNConfig, gb: GraphBatch) -> torch.Tensor:
    """SDDMM edge scores -> segment softmax -> SpMM, one
    :func:`gat_aggregate` a layer (on the card one fused kernel launch,
    with no edge-sized tensor).  The last layer averages heads
    (classification head), earlier layers concat + ELU.

    ``ctx.CURRENT.gnn_bf16_msgs`` keeps the softmax denominators and the
    messages, and their segment sums, in bf16."""
    acc_dt = torch.bfloat16 if ctx.CURRENT.gnn_bf16_msgs else torch.float32
    N, dt, plan = gb.n_nodes, _dt(cfg), gb.gat_plan()
    h = gb.node_feats.to(dt)
    n_layers = len(params["layers"])
    for i, lyr in enumerate(params["layers"]):
        H, dout = lyr["a_src"].shape
        hw = (h @ lyr["w"]).reshape(N, H, dout)
        s_src = (hw * lyr["a_src"]).sum(-1)             # (N, H)
        s_dst = (hw * lyr["a_dst"]).sum(-1)
        out = spmm_ops.gat_aggregate_ad(hw, s_src, s_dst, plan,
                                        gb.edge_mask, acc_dt,
                                        gb.gat_source_plan)
        if i < n_layers - 1:
            h = F.elu(out.float()).to(dt).reshape(N, H * dout)
        else:
            h = out.float().mean(dim=1)                 # (N, n_out)
    return h


# =========================================================================== #
# uniform entry points
# =========================================================================== #
def init_gnn(gen: torch.Generator, cfg: GNNConfig, d_feat: int, n_out: int,
             device=None) -> dict:
    """Random parameters, initialised as the reference's ``init_gnn``
    does (normal weights scaled by ``1/sqrt(shape[0])``, biases 0), drawn
    from ``gen`` — a :class:`torch.Generator` on ``device`` (default: the
    card); on ``device="meta"`` the shapes alone, and ``gen`` may be
    None."""
    device = resolve_device(device)
    if device.type != "meta" and gen.device.type != device.type:
        raise ValueError(f"generator on {gen.device}, model on {device}")
    if cfg.kind == "graphcast":
        return init_graphcast(gen, cfg, d_feat, device)
    if cfg.kind == "schnet":
        return init_schnet(gen, cfg, d_feat, device)
    if cfg.kind == "pna":
        return init_pna(gen, cfg, d_feat, n_out, device)
    if cfg.kind == "gat":
        return init_gat(gen, cfg, d_feat, n_out, device)
    raise KeyError(cfg.kind)


def gnn_forward(params: dict, cfg: GNNConfig, gb: GraphBatch) -> torch.Tensor:
    if cfg.kind == "graphcast":
        return graphcast_forward(params, cfg, gb)
    if cfg.kind == "schnet":
        return schnet_forward(params, cfg, gb)
    if cfg.kind == "pna":
        return pna_forward(params, cfg, gb)
    if cfg.kind == "gat":
        return gat_forward(params, cfg, gb)
    raise KeyError(cfg.kind)


def gnn_loss(params: dict, cfg: GNNConfig, gb: GraphBatch) -> torch.Tensor:
    """The reference's training loss, a float32 scalar: SchNet's
    per-graph energy regression (the node outputs summed over
    ``graph_id``, through the segment sum, when the batch has one, else a
    masked MSE), GraphCast's masked MSE averaged over its variables, and
    the masked cross entropy of GAT and PNA."""
    out = gnn_forward(params, cfg, gb)
    mask = gb.label_mask.float()
    denom = torch.clamp_min(mask.sum(), 1)
    if cfg.kind == "schnet":
        if gb.graph_id is not None:
            n_graphs = int(gb.labels.shape[0])
            energy = _seg_sum(out, gb.graph_id, n_graphs)
            return ((energy - gb.labels.float()) ** 2).mean()
        err = (out - gb.labels.float()) ** 2
        return (err * mask).sum() / denom
    if cfg.kind == "graphcast":
        err = (out.float() - gb.labels.float()) ** 2
        return (err.mean(-1) * mask).sum() / denom
    logits = out.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, gb.labels.long()[:, None])[:, 0]
    return ((lse - picked) * mask).sum() / denom


class ParamTree(nn.Module):
    """A nested dict or list of tensors as modules and parameters (a
    leaf's name is its path: ``layers.0.edge_mlp.1.w``); :meth:`tree`
    gives the nesting back, with the parameters as leaves."""

    def __init__(self, tree):
        super().__init__()
        self._keys = list(tree) if isinstance(tree, dict) else None
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for key, val in items:
            if isinstance(val, torch.Tensor):
                self.register_parameter(
                    str(key), nn.Parameter(val, requires_grad=False))
            else:
                self.add_module(str(key), ParamTree(val))

    def tree(self):
        def leaf(name):
            child = getattr(self, name)
            return child.tree() if isinstance(child, ParamTree) else child
        if self._keys is not None:
            return {k: leaf(str(k)) for k in self._keys}
        return [leaf(str(i)) for i in range(len(self._parameters)
                                            + len(self._modules))]


class GNNModel(nn.Module):
    """A GNN of ``cfg`` holding its parameter tree (as :func:`init_gnn`
    or ``convert.gnn_params_from_arrays`` give it) as frozen parameters;
    ``forward`` is :func:`gnn_forward` and :meth:`loss` :func:`gnn_loss`.
    The ``Trainer`` takes it as it takes the LM: it turns the gradients
    on, and reads :meth:`decayed_params` for AdamW."""

    def __init__(self, cfg: GNNConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.net = ParamTree(params)

    @property
    def params(self) -> dict:
        """The parameter tree, nested as :func:`init_gnn` gives it."""
        return self.net.tree()

    def forward(self, gb: GraphBatch) -> torch.Tensor:
        return gnn_forward(self.params, self.cfg, gb)

    def loss(self, gb: GraphBatch) -> torch.Tensor:
        return gnn_loss(self.params, self.cfg, gb)

    def decayed_params(self) -> set[str]:
        """The names of the parameters AdamW decays, by the reference's
        rule on its own tree (``ndim >= 2``): GraphCast, SchNet and PNA
        stack their per-layer weights, so every per-layer tensor there,
        biases included, counts one dimension more than it has here."""
        stacked = self.cfg.kind in STACKED_KINDS
        return {name for name, p in self.named_parameters()
                if p.ndim >= 2 or (stacked and name.startswith("net.layers."))}
