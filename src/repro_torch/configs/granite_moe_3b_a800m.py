"""granite-moe-3b-a800m — 40-expert top-8 fine-grained MoE.

[hf:ibm-granite/granite-3.0-1b-a400m-base family] 32L d_model=1536 24H
(GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512),
    long_context_mode="window",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
