"""Qwen3-14B [hf:Qwen/Qwen3 family] — 40L d=5120 40H (GQA kv=8) d_ff=17408, qk_norm."""
from repro_torch.configs.base import (ArchConfig, LM_SHAPES, TransformerConfig,
                                      scaled_transformer)

CONFIG = ArchConfig(
    arch_id="qwen3-14b",
    model=TransformerConfig(
        name="qwen3-14b",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=17408, vocab=151936, qk_norm=True, d_head=128,
        rope_theta=1e6,
    ),
    shapes=LM_SHAPES,
    notes="dense; qk-norm; GQA 40q/8kv.",
)


def reduced() -> TransformerConfig:
    return scaled_transformer(CONFIG.model, n_layers=2, d_model=64, n_heads=8,
                              n_kv_heads=2, d_ff=128, vocab=256, d_head=8)
