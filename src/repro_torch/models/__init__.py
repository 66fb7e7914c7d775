"""Unified model API, dispatched on ModelConfig.arch_type.

    init_params(cfg, gen, device=...)      -> params tree
    loss_fn(params, cfg, batch)            -> (loss, metrics)   [train]
    forward(...)                           -> logits            [prefill/eval]
    init_cache(cfg, batch, max_seq, device=...) -> cache tree   [decode]
    decode_step(params, cfg, cache, tok, pos)   -> (logits, cache)

``batch`` dicts carry an optional per-example ``weight`` — the hook used
by dual-batch learning's model-update factor.  The CNN (``resnet``), the
encoder-decoder (``encdec``, whose ``forward`` also takes the frames and
whose ``decode_step`` takes a ``window``) and every decoder-only LM
(``transformer`` with ``moe``): dense, MoE, SSM, hybrid and the
early-fusion ``vlm`` (chameleon, a decoder over a vocabulary that text
and image codes share), dispatched as the reference dispatches them.
``decode_step`` updates the cache in place and returns it.  With
``device="meta"`` and a ``MetaDraws`` in place of the generator,
``init_params`` builds the tree's shapes and dtypes and allocates
nothing (``launch.specs.abstract_params``).
"""
from __future__ import annotations

from repro_torch.models import encdec, resnet, transformer


def _mod(cfg):
    if cfg.arch_type == "cnn":
        return resnet
    if cfg.encoder_layers:
        return encdec
    return transformer


def init_params(cfg, gen, device=None):
    """``device=None`` means the card (raises without CUDA)."""
    return _mod(cfg).init_params(cfg, gen, device=device)


def loss_fn(params, cfg, batch, **kw):
    return _mod(cfg).loss_fn(params, cfg, batch, **kw)


def forward(params, cfg, *args, **kw):
    return _mod(cfg).forward(params, cfg, *args, **kw)


def init_cache(cfg, batch, max_seq, dtype=None, device=None):
    """``device=None`` means the card (raises without CUDA)."""
    m = _mod(cfg)
    if m is resnet:
        raise ValueError("CNNs have no decode cache")
    return m.init_cache(cfg, batch, max_seq, dtype, device=device)


def decode_step(params, cfg, cache, tokens, pos, **kw):
    return _mod(cfg).decode_step(params, cfg, cache, tokens, pos, **kw)
