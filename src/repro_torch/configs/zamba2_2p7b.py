"""zamba2-2.7b — hybrid Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242] 54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000,
ssm_state=64.  Mamba2 layers with one weight-tied (shared) attention+MLP
block invoked every 6 layers (zamba2's shared-block design).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, MAMBA2, SHARED_ATTN

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=256),
    layer_pattern=(MAMBA2,) * 5 + (SHARED_ATTN,),
    shared_every=6,
    long_context_mode="native",   # SSM state is O(1) in seq
    source="arXiv:2411.15242",
)
