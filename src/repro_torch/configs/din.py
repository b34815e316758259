"""DIN [arXiv:1706.06978] — embed_dim=18, hist seq 100, attn MLP 80-40, MLP 200-80,
target attention feature interaction. Production-scale sparse tables."""
import dataclasses

from repro_torch.configs.base import ArchConfig, RECSYS_SHAPES, RecsysConfig

CONFIG = ArchConfig(
    arch_id="din",
    model=RecsysConfig(
        name="din", kind="din",
        embed_dim=18, seq_len=100, attn_mlp=(80, 40), mlp=(200, 80),
        n_items=50_000_000, n_cates=1_000_000, n_user_feats=8_000_000,
    ),
    shapes=RECSYS_SHAPES,
    notes="EmbeddingBag = index_select + segment_spmm; every table "
          "gradient a segment sum by id; retrieval_cand scores 1M "
          "candidates with one matrix product.",
)


def reduced() -> RecsysConfig:
    return dataclasses.replace(CONFIG.model, embed_dim=8, seq_len=12,
                               attn_mlp=(16, 8), mlp=(32, 16),
                               n_items=1000, n_cates=100, n_user_feats=200)
