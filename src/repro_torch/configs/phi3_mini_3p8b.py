"""phi3-mini-3.8b — RoPE SwiGLU MHA. [arXiv:2404.14219]

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    arch_type="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    long_context_mode="window",
    source="arXiv:2404.14219",
)
