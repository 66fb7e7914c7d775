"""Unified model API, dispatched on ModelConfig.arch_type.

    init_params(cfg, gen, device=...)      -> params tree
    loss_fn(params, cfg, batch)            -> (loss, metrics)   [train]
    forward(...)                           -> logits            [prefill/eval]

``batch`` dicts carry an optional per-example ``weight`` — the hook used
by dual-batch learning's model-update factor.  The CNN is ported whole,
and so are the decoder-only LMs' (dense, SSM and hybrid stacks) init,
forward and loss (``transformer``; MoE blocks raise until ROADMAP
A12c/A19); the encoder-decoder models wait for A12d.
"""
from __future__ import annotations

from repro_torch.models import resnet, transformer


def _is_lm(cfg) -> bool:
    return cfg.arch_type in ("dense", "moe", "ssm", "hybrid") \
        and not cfg.encoder_layers


def _mod(cfg):
    if cfg.arch_type == "cnn":
        return resnet
    if _is_lm(cfg):
        return transformer
    raise NotImplementedError(
        f"{cfg.name} ({cfg.arch_type}) is not ported yet: it waits for "
        "ROADMAP A12d (encoder-decoder)")


def init_params(cfg, gen, device=None):
    """``device=None`` means the card (raises without CUDA)."""
    return _mod(cfg).init_params(cfg, gen, device=device)


def loss_fn(params, cfg, batch, **kw):
    return _mod(cfg).loss_fn(params, cfg, batch, **kw)


def forward(params, cfg, *args, **kw):
    return _mod(cfg).forward(params, cfg, *args, **kw)
