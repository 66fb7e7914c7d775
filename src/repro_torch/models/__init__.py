"""Unified model API, dispatched on ModelConfig.arch_type.

    init_params(cfg, gen, device=...)      -> params tree
    loss_fn(params, cfg, batch)            -> (loss, metrics)   [train]
    forward(...)                           -> logits            [eval]

``batch`` dicts carry an optional per-example ``weight`` — the hook used
by dual-batch learning's model-update factor.  The CNN is ported whole;
dense LMs have their parameter init (``transformer``) for the serving
slice, whose step lives in ``serve.paged``; their training forward and
loss wait for ROADMAP A12, the encoder-decoder and recurrent models for
their slices.
"""
from __future__ import annotations

from repro_torch.models import resnet, transformer


def _unported(cfg):
    if cfg.arch_type in ("ssm", "hybrid") or cfg.ssm is not None:
        slice_ = "ROADMAP A14 (recurrent archs)"
    else:
        slice_ = "ROADMAP A12 (LM training path)"
    return NotImplementedError(
        f"{cfg.name} ({cfg.arch_type}) is not ported yet: it waits for "
        f"{slice_}")


def _is_lm(cfg) -> bool:
    return cfg.arch_type in ("dense", "moe") and not cfg.encoder_layers \
        and cfg.ssm is None


def _mod(cfg):
    if cfg.arch_type == "cnn":
        return resnet
    raise _unported(cfg)


def init_params(cfg, gen, device=None):
    """``device=None`` means the card (raises without CUDA)."""
    if _is_lm(cfg):
        return transformer.init_params(cfg, gen, device=device)
    return _mod(cfg).init_params(cfg, gen, device=device)


def loss_fn(params, cfg, batch, **kw):
    return _mod(cfg).loss_fn(params, cfg, batch, **kw)


def forward(params, cfg, *args, **kw):
    return _mod(cfg).forward(params, cfg, *args, **kw)
