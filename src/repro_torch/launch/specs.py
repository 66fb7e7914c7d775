"""Abstract inputs and parameters for every (arch x input shape) pair.

The reference's ``jax.ShapeDtypeStruct`` stand-ins become tensors on the
meta device with the same shapes and dtypes: nothing is allocated, so the
full-size configs (llama3-405b's 405.9 G parameters, a ``decode_32k``
cache of 128 x 32,768 positions) are built as trees of shapes.
"""
from __future__ import annotations

import torch

from repro_torch import models
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.layers import MetaDraws, dtype_of

META = torch.device("meta")


def effective_window(cfg: ModelConfig, shape: InputShape) -> int:
    """long_500k on full-attention archs runs the documented sliding-window
    variant (``attn_window_override``); native sub-quadratic archs run
    unmodified."""
    if shape.name == "long_500k" and cfg.long_context_mode == "window":
        return cfg.attn_window_override
    return 0


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Abstract inputs for the step function of this shape's kind: int32
    tokens and labels, f32 example weights, the encoder-decoder's frames
    ``(B, encoder_seq, d_model)`` in the compute dtype, and for decode the
    cache of ``models.init_cache``, one token a row and a 0-d int32
    ``pos``."""
    b, s = shape.global_batch, shape.seq_len
    cdt = dtype_of(cfg.compute_dtype)
    tok = lambda *sh: _meta(sh, torch.int32)

    if shape.kind == "train":
        batch = {"tokens": tok(b, s), "labels": tok(b, s),
                 "weight": _meta((b,), torch.float32)}
        if cfg.encoder_layers:
            batch["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), cdt)
        return {"batch": batch}

    if shape.kind == "prefill":
        out = {"tokens": tok(b, s)}
        if cfg.encoder_layers:
            out["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), cdt)
        return out

    if shape.kind == "decode":
        cache = models.init_cache(cfg, b, s, device=META)
        return {"cache": cache, "tokens": tok(b, 1),
                "pos": _meta((), torch.int32)}

    raise ValueError(shape.kind)


def abstract_params(cfg: ModelConfig):
    """The parameter tree of ``cfg`` on the meta device: the shapes and
    dtypes ``models.init_params`` gives, with no storage."""
    return models.init_params(cfg, MetaDraws(), device=META)
