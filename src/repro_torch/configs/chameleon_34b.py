"""chameleon-34b — early-fusion VLM; VQ image tokens share the text vocab.

[arXiv:2405.09818] 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.

The VQ image tokenizer is the stubbed modality frontend: ``input_specs``
provides token ids in the shared vocabulary (early fusion means the backbone
is a plain decoder LM over interleaved text+image codes).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    head_dim=128,
    long_context_mode="window",
    source="arXiv:2405.09818",
)
