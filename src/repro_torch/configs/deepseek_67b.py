"""deepseek-67b — dense llama-arch. [arXiv:2401.02954]

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    arch_type="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    head_dim=128,
    long_context_mode="window",   # full attention: documented 500k window variant
    source="arXiv:2401.02954",
)
