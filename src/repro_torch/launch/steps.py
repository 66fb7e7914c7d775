"""Step functions shared by the entry points: the prefill step.

``make_train_step`` and ``make_decode_step`` of the reference wait for
the LM training path and the decode slice (ROADMAP A12, A14)."""
from __future__ import annotations

import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.device import strict_f32


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
