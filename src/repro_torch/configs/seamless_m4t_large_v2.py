"""seamless-m4t-large-v2 — encoder-decoder, multimodal (audio).

[arXiv:2308.11596] 24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.

The mel-spectrogram + conformer feature extractor is the stubbed modality
frontend: the caller passes precomputed source frame embeddings of shape
(batch, encoder_seq, d_model) in the compute dtype (``launch.specs
.input_specs``); the port implements the transformer encoder-decoder
backbone that consumes them.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    n_layers=24,            # decoder layers
    encoder_layers=24,      # encoder layers over frame embeddings
    encoder_seq=4096,       # fixed source frame count for input specs
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    long_context_mode="window",   # decoder self-attn window variant at 500k
    source="arXiv:2308.11596",
)
