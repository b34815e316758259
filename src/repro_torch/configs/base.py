"""Config dataclasses of the LM, GNN and recsys families: a
field-for-field copy of the reference's ``configs/base.py`` (transformer,
MoE, MLA, GNN and recsys configs, the LM, GNN and recsys shape cells), so
one kwargs dict builds the same config in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


# --------------------------------------------------------------------------- #
# Shapes
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell. ``kind`` selects which step it drives."""

    name: str
    kind: str  # train | prefill | decode | long_decode | full_graph | minibatch | batched_graphs | serve | retrieval
    dims: dict[str, int] = field(default_factory=dict)

    def __getitem__(self, k: str) -> int:
        return self.dims[k]


LM_SHAPES = (
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec("long_500k", "long_decode", {"seq_len": 524288, "global_batch": 1}),
)

GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "full_graph",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    ShapeSpec("minibatch_lg", "minibatch",
              {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
               "fanout0": 15, "fanout1": 10, "d_feat": 602}),
    ShapeSpec("ogb_products", "full_graph",
              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100}),
    ShapeSpec("molecule", "batched_graphs",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16}),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", {"batch": 65536}),
    ShapeSpec("serve_p99", "serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1000000}),
)


# --------------------------------------------------------------------------- #
# Model configs
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    n_shared: int = 0             # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_free: bool = False  # DeepSeek-V3 aux-loss-free bias routing
    first_k_dense: int = 0        # leading dense layers (DeepSeek-V3: 3)
    d_ff_dense: int = 0           # FFN dim of those dense layers


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention dims."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    mtp_depth: int = 0            # multi-token-prediction extra heads (DeepSeek-V3)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    family: str = "lm"

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), used for roofline."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.mla is not None:
            m = self.mla
            qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
            attn = (d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_head
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        else:
            hd = self.head_dim
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d
        if self.moe is not None:
            mo = self.moe
            moe_ffn = 3 * d * mo.d_expert * (mo.n_experts + mo.n_shared) \
                + d * mo.n_experts
            dense_ffn = 3 * d * (mo.d_ff_dense or self.d_ff)
            ffn_total = (mo.first_k_dense * dense_ffn
                         + (L - mo.first_k_dense) * moe_ffn)
        else:
            ffn_total = L * 3 * d * self.d_ff
        return emb + L * attn + ffn_total + L * 2 * d

    def active_param_count(self) -> int:
        """Per-token active params (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        mo = self.moe
        full = self.param_count()
        all_experts = (L - mo.first_k_dense) * 3 * d * mo.d_expert * mo.n_experts
        active_experts = (L - mo.first_k_dense) * 3 * d * mo.d_expert * mo.top_k
        return full - all_experts + active_experts


@dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                     # graphcast | schnet | pna | gat
    n_layers: int
    d_hidden: int
    aggregator: str = "sum"
    n_heads: int = 1
    # schnet
    n_rbf: int = 0
    cutoff: float = 0.0
    # graphcast
    mesh_refinement: int = 0
    n_vars: int = 0
    # pna
    aggregators: tuple[str, ...] = ()
    scalers: tuple[str, ...] = ()
    n_classes: int = 47           # ogbn-products has 47 classes
    dtype: str = "bfloat16"
    family: str = "gnn"


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str = "din"
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple[int, ...] = (80, 40)
    mlp: tuple[int, ...] = (200, 80)
    n_items: int = 50_000_000     # production-scale sparse table (rows)
    n_cates: int = 1_000_000
    n_user_feats: int = 8_000_000
    dtype: str = "bfloat16"
    family: str = "recsys"


ModelConfig = Any  # TransformerConfig | GNNConfig | RecsysConfig


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    model: ModelConfig
    shapes: tuple[ShapeSpec, ...]
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id}: unknown shape {name!r}; "
                       f"have {[s.name for s in self.shapes]}")


def scaled_transformer(cfg: TransformerConfig, **over) -> TransformerConfig:
    return dataclasses.replace(cfg, **over)
