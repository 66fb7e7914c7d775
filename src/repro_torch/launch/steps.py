"""Step functions shared by the entry points: the train step and the
prefill step.

``make_decode_step`` of the reference waits for the decode slice
(ROADMAP A12b, A14)."""
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
    """(params, tokens) -> last-position logits (B, V), under
    ``torch.inference_mode()`` (the kernels on its path have no
    backward).  On the card it turns TF32 off first (process-wide, as the
    engines do): an f32 config computes in f32."""
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder prefill waits for ROADMAP A12")

    def prefill(params, tokens):
        strict_f32(tokens.device)
        with torch.inference_mode():
            logits = models.forward(params, cfg, tokens, last_only=True)
        return logits[:, 0]
    return prefill
