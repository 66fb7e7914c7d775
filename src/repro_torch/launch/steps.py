"""Step functions shared by the entry points: the train step, the
prefill step and the decode step."""
from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch import models
from repro_torch.configs.base import ATTN, ATTN_LOCAL, InputShape, ModelConfig
from repro_torch.core.dtensor import is_dtensor
from repro_torch.device import strict_f32
from repro_torch.launch.hlo_analysis import active
from repro_torch.launch.specs import effective_window
from repro_torch.optim import Optimizer


def with_window_override(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """``cfg`` as it runs ``shape``: where ``effective_window`` gives a
    window (long_500k on a full-attention decoder), every global
    attention layer becomes a sliding-window one of that width."""
    w = effective_window(cfg, shape)
    if w and not cfg.encoder_layers:
        return replace(cfg, local_global_ratio=0, attn_window=w,
                       layer_pattern=tuple(ATTN_LOCAL if k == ATTN else k
                                           for k in cfg.blocks))
    return cfg


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
    backward), or ``torch.no_grad()`` on a mesh or under a cost count
    (``launch.hlo_analysis``): inference mode bypasses the count's
    dispatch mode, and DTensor's collectives refuse inference tensors.
    On the card it turns TF32 off first (process-wide, as the engines
    do): an f32 config computes in f32."""
    def last_logits(params, tokens, *frames):
        strict_f32(tokens.device)
        plain = active() is None and not is_dtensor(tokens)
        with torch.inference_mode() if plain else torch.no_grad():
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
    (process-wide, as the prefill step does).

    ``shape`` (an input shape) sets the window the step runs with
    (``effective_window``): an encoder-decoder's self-attention takes it
    as ``window`` (0 otherwise) and reads the encoder output from
    ``cache["enc_out"]``; any other config steps as
    ``with_window_override(cfg, shape)``, so at long_500k every global
    attention layer of a full-attention decoder attends to the last
    ``attn_window_override`` keys only.  The cache is the config's own
    (``models.init_cache(cfg, ...)``, every position kept)."""
    kw = {}
    if cfg.encoder_layers:
        kw["window"] = effective_window(cfg, shape) if shape else 0
    elif shape is not None:
        cfg = with_window_override(cfg, shape)

    def decode(params, cache, tokens, pos):
        strict_f32(tokens.device)
        logits, cache = models.decode_step(params, cfg, cache, tokens, pos,
                                           **kw)
        return logits[:, -1], cache
    return decode
