"""Qwen3-4B [hf:Qwen/Qwen3 family] — 36L d=2560 32H (GQA kv=8) d_ff=9728, qk_norm."""
from repro_torch.configs.base import (ArchConfig, LM_SHAPES, TransformerConfig,
                                      scaled_transformer)

CONFIG = ArchConfig(
    arch_id="qwen3-4b",
    model=TransformerConfig(
        name="qwen3-4b",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
        d_ff=9728, vocab=151936, qk_norm=True, d_head=128,
        rope_theta=1e6, tie_embeddings=True,
    ),
    shapes=LM_SHAPES,
    notes="dense; qk-norm; GQA 32q/8kv; tied embeddings.",
)


def reduced() -> TransformerConfig:
    return scaled_transformer(CONFIG.model, n_layers=2, d_model=64, n_heads=8,
                              n_kv_heads=2, d_ff=128, vocab=256, d_head=8)
