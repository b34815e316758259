"""DeepSeek-V3-671B [arXiv:2412.19437] — 61L d=7168 128H MLA, 1 shared + 256 routed
top-8 (aux-loss-free), d_expert=2048, first 3 layers dense (d_ff=18432), MTP depth 1."""
from repro_torch.configs.base import (ArchConfig, LM_SHAPES, MLAConfig,
                                      MoEConfig, TransformerConfig,
                                      scaled_transformer)

CONFIG = ArchConfig(
    arch_id="deepseek-v3-671b",
    model=TransformerConfig(
        name="deepseek-v3-671b",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=18432, vocab=129280,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                      router_aux_free=True, first_k_dense=3, d_ff_dense=18432),
        mtp_depth=1,
    ),
    shapes=LM_SHAPES,
    notes="MLA + DeepSeekMoE; KV cache holds only (kv_lora_rank + rope) per token.",
)


def reduced() -> TransformerConfig:
    import dataclasses
    m = CONFIG.model
    return scaled_transformer(
        m, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=dataclasses.replace(m.moe, n_experts=4, top_k=2, d_expert=32,
                                first_k_dense=1, d_ff_dense=128),
        mtp_depth=1,
    )
