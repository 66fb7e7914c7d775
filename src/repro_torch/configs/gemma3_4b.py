"""gemma3-4b — 5:1 local:global attention, 128k context, 256k vocab.

[hf:google/gemma-3-1b-pt family] 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144.  Five sliding-window (1024) layers per global layer.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    arch_type="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    head_dim=256,
    local_global_ratio=5,
    attn_window=1024,
    long_context_mode="native",   # 5:1 local layers bound the cache; decode O(S)
    source="hf:google/gemma-3-1b-pt",
)
