"""Step functions shared by the entry points: the train step, the
prefill step and the decode step."""
from __future__ import annotations

import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.device import strict_f32
from repro_torch.optim import Optimizer


def make_train_step(cfg: ModelConfig, optimizer: Optimizer):
    """(params, opt_state, batch, lr) -> (params, opt_state, loss).

    batch["weight"] carries the dual-batch per-example contributions.
    Canonical implementation: ``repro_torch.engine.steps
    .make_weighted_step`` (this wrapper returns the loss scalar)."""
    from repro_torch.engine.steps import make_weighted_step
    step = make_weighted_step(cfg, optimizer)

    def train_step(params, opt_state, batch, lr):
        params, opt_state, metrics = step(params, opt_state, batch, lr)
        return params, opt_state, metrics["loss"]
    return train_step


def make_prefill_step(cfg: ModelConfig):
    """(params, tokens) -> last-position logits (B, V); for an
    encoder-decoder (params, tokens, frames), the frames (B, S_enc, D).
    Under ``torch.inference_mode()`` (the kernels on its path have no
    backward).  On the card it turns TF32 off first (process-wide, as the
    engines do): an f32 config computes in f32."""
    def last_logits(params, tokens, *frames):
        strict_f32(tokens.device)
        with torch.inference_mode():
            logits = models.forward(params, cfg, tokens, *frames,
                                    last_only=True)
        return logits[:, 0]

    if cfg.encoder_layers:
        def prefill(params, tokens, frames):
            return last_logits(params, tokens, frames)
        return prefill

    def prefill(params, tokens):
        return last_logits(params, tokens)
    return prefill


def make_decode_step(cfg: ModelConfig, shape=None):
    """(params, cache, tokens, pos) -> (logits (B, V), cache).

    tokens may be a chunk (B, T >= 1): attention archs take a whole
    prompt or a chunk of one through the same step, and the returned
    logits are those of the LAST chunk position — the classic one-token
    decode when T = 1.  ``pos`` is a host int, or for T = 1 a 0-d integer
    tensor on the tokens' device (the reference's traced ``pos``), read
    on the device with no copy to the host: then the caller keeps ``0 <=
    pos < max_seq`` (``models.decode_step``).  The cache is updated in
    place and returned.  On the card it turns TF32 off first
    (process-wide, as the prefill step does).  An encoder-decoder's step
    runs with window 0 and reads the encoder output from
    ``cache["enc_out"]``.

    ``shape`` (an input shape whose window overrides the config's) needs
    ``launch/specs.py``'s ``effective_window`` and
    ``with_window_override``, which come with ROADMAP A12e."""
    if shape is not None:
        raise NotImplementedError(
            "make_decode_step(shape=...) needs launch/specs.py "
            "(effective_window, with_window_override): ROADMAP A12e")
    kw = {"window": 0} if cfg.encoder_layers else {}

    def decode(params, cache, tokens, pos):
        strict_f32(tokens.device)
        logits, cache = models.decode_step(params, cfg, cache, tokens, pos,
                                           **kw)
        return logits[:, -1], cache
    return decode
