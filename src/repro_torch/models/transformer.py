"""Decoder-only LM: the layer layout, parameter init and the prefill
forward for attention, Mamba2, RWKV-6 and hybrid stacks.

The layer stack is a list of *segments* — maximal runs of identical
block kinds — each holding stacked ``(count, ...)`` per-layer tensors,
the reference's tree layout (``params["segments"][i]`` with the same key
paths), so weights carry over from the JAX package as a plain mapping.
Local/global attention (gemma3) stays one segment: the sliding window is
a per-layer value (0 = global).  Hybrid stacks (zamba2) alternate Mamba2
segments with calls of one weight-tied attention block
(``params["shared"]``), whose segments hold no parameters (``{}``).

``forward`` walks each segment's layers in a Python loop (the
reference's ``lax.scan``; remat has no meaning without a backward).  On
the card its attention is the kernel B4, its SSD scans B7 and its WKV
recurrences B8.  The loss waits for the LM training path (ROADMAP A12),
``init_cache`` / ``decode_step`` for the decode slice (A14); serving runs
its own step (``serve.paged``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, MAMBA2, ModelConfig,
                                      RWKV6, SHARED_ATTN)
from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import mamba2 as m2
from repro_torch.models import rwkv6 as rk
from repro_torch.models.attention import attention_block
from repro_torch.models.layers import dtype_of, rms_norm, swiglu


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
    dev = gen.device
    zeros = lambda: torch.zeros((*lead, d), dtype=torch.float32, device=dev)
    normal = lambda shape, scale, dt: _normal(gen, shape, scale, dt)
    if kind == MAMBA2:
        return {"ln1": zeros(), "mamba": m2.init_mamba2(normal, cfg, dtype,
                                                        lead)}
    if kind == RWKV6:
        return {"ln1": zeros(), "rwkv": rk.init_rwkv6(normal, cfg, dtype,
                                                      lead),
                "ln2": zeros()}
    if kind != ATTN:
        raise ValueError(f"{cfg.name}: no parameters for a {kind} block")
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE blocks are not ported yet: they wait for "
            "ROADMAP A12 (models/moe.py) and A19 (MoE serving)")
    return {"ln1": zeros(),
            "attn": _init_attn_layer(gen, cfg, dtype, lead),
            "ln2": zeros(),
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
        params["shared"] = _init_block(gen, cfg, ATTN, dtype)
    for seg in layout(cfg):
        params["segments"].append(
            {} if seg.kind == SHARED_ATTN
            else _init_block(gen, cfg, seg.kind, dtype, (seg.count,)))
    return params


# --------------------------- forward ----------------------------------------
def _attn_block_body(p, x, cfg, window, positions):
    h = x + attention_block(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                            cfg, window=window, positions=positions)
    hin = rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + swiglu(hin, p["mlp"]["wi"], p["mlp"]["wg"], p["mlp"]["wo"])


def _mamba_block_body(p, x, cfg):
    return x + m2.mamba2_block(p["mamba"], rms_norm(x, p["ln1"],
                                                    cfg.norm_eps), cfg)


def _rwkv_block_body(p, x, cfg):
    y, _, _ = rk.time_mix(p["rwkv"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg)
    h = x + y
    y, _ = rk.channel_mix(p["rwkv"], rms_norm(h, p["ln2"], cfg.norm_eps), cfg)
    return h + y


def forward(params, cfg: ModelConfig, tokens, *, positions=None,
            embeddings=None, last_only: bool = False,
            return_hidden: bool = False):
    """tokens: (B, S) int -> logits (B, S, V) in the compute dtype (B, 1, V
    with ``last_only``; the final-normed hidden states with
    ``return_hidden``).

    embeddings: optional (B, S, D) — overrides the token embedding.
    Dropout is the identity (rate 0): training waits for ROADMAP A12."""
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: the MoE forward waits for ROADMAP A12 "
            "(models/moe.py)")
    cdt = dtype_of(cfg.compute_dtype)
    if embeddings is None:
        x = params["embed"][tokens].to(cdt)
    else:
        x = embeddings.to(cdt)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)

    for seg, sp in zip(layout(cfg), params["segments"]):
        if seg.kind == SHARED_ATTN:
            x = _attn_block_body(params["shared"], x, cfg, 0, positions)
            continue
        for i in range(seg.count):
            p = tree_map(lambda t: t[i], sp)
            if seg.kind == ATTN:
                x = _attn_block_body(p, x, cfg, seg.windows[i], positions)
            elif seg.kind == MAMBA2:
                x = _mamba_block_body(p, x, cfg)
            elif seg.kind == RWKV6:
                x = _rwkv_block_body(p, x, cfg)
            else:
                raise ValueError(seg.kind)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    if return_hidden:
        return x
    head = params.get("lm_head", params["embed"])
    return torch.einsum("bsd,vd->bsv", x, head)
