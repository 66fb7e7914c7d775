"""arctic-480b — 128-expert top-2 MoE with dense residual MLP.

[hf:Snowflake/snowflake-arctic-base] 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000, MoE 128e top-2 + dense residual.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual=True),
    long_context_mode="window",
    source="hf:Snowflake/snowflake-arctic-base",
)
