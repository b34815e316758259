"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B] — 24L d=1024 16H kv=16 d_ff=2816, QKV bias."""
from repro_torch.configs.base import (ArchConfig, LM_SHAPES, TransformerConfig,
                                      scaled_transformer)

CONFIG = ArchConfig(
    arch_id="qwen1.5-0.5b",
    model=TransformerConfig(
        name="qwen1.5-0.5b",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=2816, vocab=151936, qkv_bias=True, tie_embeddings=True,
        rope_theta=1e6,
    ),
    shapes=LM_SHAPES,
    notes="dense; QKV bias; tied embeddings.",
)


def reduced() -> TransformerConfig:
    return scaled_transformer(CONFIG.model, n_layers=2, d_model=64, n_heads=4,
                              n_kv_heads=4, d_ff=128, vocab=256)
