"""OLMoE-1B-7B [arXiv:2409.02060] — 16L d=2048 16H (kv=16) MoE 64e top-8, d_expert=1024."""
from repro_torch.configs.base import (ArchConfig, LM_SHAPES, MoEConfig,
                                      TransformerConfig, scaled_transformer)

CONFIG = ArchConfig(
    arch_id="olmoe-1b-7b",
    model=TransformerConfig(
        name="olmoe-1b-7b",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab=50304, qk_norm=True,
        moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024),
    ),
    shapes=LM_SHAPES,
    notes="64-expert top-8 MoE; every layer MoE; GQA kv=16 (== MHA).",
)


def reduced() -> TransformerConfig:
    import dataclasses
    return scaled_transformer(
        CONFIG.model, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        moe=dataclasses.replace(CONFIG.model.moe, n_experts=4, top_k=2, d_expert=32),
    )
