"""Decoder-only LM: the layer layout and parameter init (the parts the
serving slice needs).

The layer stack is a list of *segments* — maximal runs of identical
block kinds — each holding stacked ``(count, ...)`` per-layer tensors,
the reference's tree layout (``params["segments"][i]`` with the same key
paths), so weights carry over from the JAX package as a plain mapping.
Local/global attention (gemma3) stays one segment: the sliding window is
a per-layer value (0 = global).

The forward pass, loss and ``decode_step`` of the reference wait for the
LM slice (ROADMAP A12); serving runs its own step (``serve.paged``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, MAMBA2, ModelConfig,
                                      RWKV6, SHARED_ATTN)
from repro_torch.device import resolve_device
from repro_torch.models.layers import dtype_of


@dataclass(frozen=True)
class Segment:
    kind: str                 # "attn" | "mamba2" | "rwkv6" | "shared_attn"
    count: int
    windows: Tuple[int, ...]  # per-layer window (attn segments; 0=global)


def layout(cfg: ModelConfig) -> Tuple[Segment, ...]:
    segs = []
    for kind in cfg.blocks:
        w = 0
        k = kind
        if kind == ATTN_LOCAL:
            k, w = ATTN, cfg.attn_window
        if segs and segs[-1][0] == k and k != SHARED_ATTN:
            segs[-1][1] += 1
            segs[-1][2].append(w)
        else:
            segs.append([k, 1, [w]])
    return tuple(Segment(k, c, tuple(ws)) for k, c, ws in segs)


# --------------------------- init ------------------------------------------
def _normal(gen: torch.Generator, shape, scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    """``scale · N(0, 1)`` in f32, cast to ``dtype``, drawn from ``gen`` on
    its own device (the reference's ``normal_init``)."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def _init_attn_layer(gen, cfg, dtype, lead=()):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sc = d ** -0.5
    return {
        "wq": _normal(gen, (*lead, d, h * hd), sc, dtype),
        "wk": _normal(gen, (*lead, d, kv * hd), sc, dtype),
        "wv": _normal(gen, (*lead, d, kv * hd), sc, dtype),
        "wo": _normal(gen, (*lead, h * hd, d), (h * hd) ** -0.5, dtype),
    }


def _init_mlp(gen, cfg, dtype, lead=()):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": _normal(gen, (*lead, d, f), d ** -0.5, dtype),
        "wg": _normal(gen, (*lead, d, f), d ** -0.5, dtype),
        "wo": _normal(gen, (*lead, f, d), f ** -0.5, dtype),
    }


def _init_block(gen, cfg, kind, dtype, lead=()):
    """One block's parameters, with ``lead`` stacking dims in front (a
    segment draws all its layers at once)."""
    d = cfg.d_model
    if kind != ATTN:
        item = ("ROADMAP A14 (recurrent archs)" if kind in (MAMBA2, RWKV6)
                else "ROADMAP A12 (LM training path)")
        raise NotImplementedError(
            f"{cfg.name}: {kind} blocks are not ported yet: they wait for "
            f"{item}")
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE blocks are not ported yet: they wait for "
            "ROADMAP A12 (models/moe.py) and A19 (MoE serving)")
    dev = gen.device
    return {"ln1": torch.zeros((*lead, d), dtype=torch.float32, device=dev),
            "attn": _init_attn_layer(gen, cfg, dtype, lead),
            "ln2": torch.zeros((*lead, d), dtype=torch.float32, device=dev),
            "mlp": _init_mlp(gen, cfg, dtype, lead)}


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None):
    """The full parameter tree on ``device`` (``None`` means the card),
    drawn from ``gen``, which must live on that device: the reference's
    shapes, scales and dtypes (``param_dtype`` weights, f32 norms), not
    its bits."""
    device = resolve_device(device)
    if gen.device.type != device.type:
        raise ValueError(f"the generator lives on {gen.device}, the params "
                         f"go to {device}: draw them where they live")
    dtype = dtype_of(cfg.param_dtype)
    d, v = cfg.d_model, cfg.vocab_size
    params = {
        "embed": _normal(gen, (v, d), 0.02, dtype),
        "final_norm": torch.zeros((d,), dtype=torch.float32, device=device),
        "segments": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(gen, (v, d), d ** -0.5, dtype)
    if cfg.shared_every:
        params["shared"] = _init_block(gen, cfg, SHARED_ATTN, dtype)
    for seg in layout(cfg):
        params["segments"].append(
            _init_block(gen, cfg, seg.kind, dtype, (seg.count,)))
    return params
