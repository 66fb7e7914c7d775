"""Unified model API, dispatched on ModelConfig.arch_type.

    init_params(cfg, gen, device=...)      -> params tree
    loss_fn(params, cfg, batch)            -> (loss, metrics)   [train]
    forward(...)                           -> logits            [eval]

``batch`` dicts carry an optional per-example ``weight`` — the hook used
by dual-batch learning's model-update factor.  Only the CNN is ported;
the LM, encoder-decoder and recurrent models wait for their slices.
"""
from __future__ import annotations

from repro_torch.models import resnet


def _mod(cfg):
    if cfg.arch_type == "cnn":
        return resnet
    if cfg.arch_type in ("ssm", "hybrid") or cfg.ssm is not None:
        slice_ = "ROADMAP A14 (recurrent archs)"
    else:
        slice_ = "ROADMAP A12 (LM training path)"
    raise NotImplementedError(
        f"{cfg.name} ({cfg.arch_type}) is not ported yet: it waits for "
        f"{slice_}")


def init_params(cfg, gen, device=None):
    """``device=None`` means the card (raises without CUDA)."""
    return _mod(cfg).init_params(cfg, gen, device=device)


def loss_fn(params, cfg, batch, **kw):
    return _mod(cfg).loss_fn(params, cfg, batch, **kw)


def forward(params, cfg, *args, **kw):
    return _mod(cfg).forward(params, cfg, *args, **kw)
