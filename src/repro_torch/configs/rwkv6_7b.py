"""rwkv6-7b (Finch) — attention-free, data-dependent decay.

[arXiv:2404.05892] 32L d_model=4096 d_ff=14336 vocab=65536.
"""
from repro_torch.configs.base import ModelConfig, RWKV6

CONFIG = ModelConfig(
    name="rwkv6-7b",
    arch_type="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,           # wkv head size 64
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    layer_pattern=(RWKV6,),
    long_context_mode="native",   # recurrent state, O(1) in seq
    source="arXiv:2404.05892",
)
