"""Decoder-only LM: the layer layout, parameter init, the forward and the
weighted-example loss for attention, Mamba2, RWKV-6 and hybrid stacks.

The layer stack is a list of *segments* — maximal runs of identical
block kinds — each holding stacked ``(count, ...)`` per-layer tensors,
the reference's tree layout (``params["segments"][i]`` with the same key
paths), so weights carry over from the JAX package as a plain mapping.
Local/global attention (gemma3) stays one segment: the sliding window is
a per-layer value (0 = global).  Hybrid stacks (zamba2) alternate Mamba2
segments with calls of one weight-tied attention block
(``params["shared"]``), whose segments hold no parameters (``{}``).

``forward`` walks each segment's layers in a Python loop (the
reference's ``lax.scan``), taking the layers' tensors apart with one
``unbind`` per stacked leaf, so the backward gathers a segment's
gradients with one ``stack`` (a per-layer index would make a zero
tensor of the whole stacked leaf per layer).  ``cfg.remat`` checkpoints
each block (``"block"``) or recomputes all but its matrix products
(``"dots"``) in the backward.  Its attention, SSD scans and WKV
recurrences run the kernels B4 / B7 / B8 on the card, which have no
backward; ``train=True`` (``loss_fn`` passes it) runs the ports of the
reference's scans instead, on any device, as the reference's training
forward does.  ``init_cache`` / ``decode_step`` wait for the decode slice
(A14); serving runs its own step (``serve.paged``).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, MAMBA2, ModelConfig,
                                      RWKV6, SHARED_ATTN)
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.device import resolve_device
from repro_torch.models import mamba2 as m2
from repro_torch.models import rwkv6 as rk
from repro_torch.models.attention import attention_block
from repro_torch.models.layers import (chunked_cross_entropy, cross_entropy,
                                      dropout, dtype_of, rms_norm, swiglu)


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
def _attn_block_body(p, x, cfg, window, positions, drop_seed, drop_rate,
                     train):
    h = x + attention_block(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                            cfg, window=window, positions=positions,
                            train=train)
    hin = rms_norm(h, p["ln2"], cfg.norm_eps)
    y = swiglu(hin, p["mlp"]["wi"], p["mlp"]["wg"], p["mlp"]["wo"])
    return h + dropout(y, _layer_gen(x.device, drop_seed), drop_rate)


def _mamba_block_body(p, x, cfg, train):
    return x + m2.mamba2_block(p["mamba"], rms_norm(x, p["ln1"],
                                                    cfg.norm_eps), cfg,
                               train=train)


def _rwkv_block_body(p, x, cfg, train):
    y, _, _ = rk.time_mix(p["rwkv"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                          train=train)
    h = x + y
    y, _ = rk.channel_mix(p["rwkv"], rms_norm(h, p["ln2"], cfg.norm_eps), cfg)
    return h + y


def _layer_seed(drop_rng, li: int):
    """Layer ``li``'s dropout seed: the step generator's seed with the
    layer folded in (the reference's ``fold_in(drop_rng, li)``); None
    without dropout."""
    if drop_rng is None:
        return None
    return (drop_rng.initial_seed() * 1_000_003 + li + 1) % 2**63


def _layer_gen(device, seed):
    """A fresh generator from ``seed``, built inside the block so that a
    checkpointed block draws the same mask again when recomputed."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


_SAVED_OPS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
              torch.ops.aten.addmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the matrix products' outputs, recompute the
    rest (the reference's ``dots_saveable``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg, body, x):
    """``body(x)`` under the config's remat policy (only where a backward
    will run)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return body(x)
    if cfg.remat == "block":
        return checkpoint(body, x, use_reentrant=False)
    if cfg.remat == "dots":
        return checkpoint(body, x, use_reentrant=False, context_fn=partial(
            create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


def _layers(sp, count: int):
    """A stacked segment's per-layer trees, one ``unbind`` per leaf."""
    leaves, treedef = tree_flatten(sp)
    per = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, [p[i] for p in per])
            for i in range(count)]


def forward(params, cfg: ModelConfig, tokens, *, drop_rng=None,
            drop_rate: float = 0.0, positions=None, embeddings=None,
            return_aux: bool = False, last_only: bool = False,
            return_hidden: bool = False, train: bool = False):
    """tokens: (B, S) int -> logits (B, S, V) in the compute dtype (B, 1, V
    with ``last_only``; the final-normed hidden states with
    ``return_hidden``) [, the aux load-balance loss: 0 without MoE].

    embeddings: optional (B, S, D) — overrides the token embedding.
    drop_rng: a ``torch.Generator`` whose seed keys every attention
    block's dropout (at ``drop_rate``) on the MLP output, per layer.
    train: run the differentiable scans in place of B4 / B7 / B8 on the
    card (the training forward; see the module docstring)."""
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

    def attn(p, w, li):
        return partial(_attn_block_body, p, cfg=cfg, window=w,
                       positions=positions,
                       drop_seed=_layer_seed(drop_rng, li),
                       drop_rate=drop_rate, train=train)

    li = 0
    for seg, sp in zip(layout(cfg), params["segments"]):
        if seg.kind == SHARED_ATTN:
            x = _remat(cfg, attn(params["shared"], 0, li), x)
            li += 1
            continue
        for i, p in enumerate(_layers(sp, seg.count)):
            if seg.kind == ATTN:
                body = attn(p, seg.windows[i], li + i)
            elif seg.kind == MAMBA2:
                body = partial(_mamba_block_body, p, cfg=cfg, train=train)
            elif seg.kind == RWKV6:
                body = partial(_rwkv_block_body, p, cfg=cfg, train=train)
            else:
                raise ValueError(seg.kind)
            x = _remat(cfg, body, x)
        li += seg.count

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    if return_hidden:
        out = x
    else:
        head = params.get("lm_head", params["embed"])
        out = torch.einsum("bsd,vd->bsv", x, head)
    return (out, 0.0) if return_aux else out


def loss_fn(params, cfg: ModelConfig, batch, *, drop_rng=None,
            drop_rate: float = 0.0):
    """Weighted-example LM loss — the dual-batch hook.

    batch: {"tokens": (B, S), "labels": (B, S), optional "weight": (B,)
    per-example contribution (model-update factor x validity mask; see
    ``core/spmd_dual_batch.py``), optional "embeddings": (B, S, D)}.
    Runs the training forward (``train=True``), and for a vocabulary of
    65536 or more the chunked CE, which never makes the (B, S, V) f32
    logits.  Returns (loss, {"loss", "per_example"})."""
    fw = dict(drop_rng=drop_rng, drop_rate=drop_rate,
              embeddings=batch.get("embeddings"), return_aux=True,
              train=True)
    if cfg.vocab_size >= 65536:
        hidden, _ = forward(params, cfg, batch["tokens"], return_hidden=True,
                            **fw)
        head = params.get("lm_head", params["embed"])
        per_ex = chunked_cross_entropy(hidden, head, batch["labels"])
    else:
        logits, _ = forward(params, cfg, batch["tokens"], **fw)
        per_ex = cross_entropy(logits, batch["labels"])        # (B,)
    w = batch.get("weight")
    if w is None:
        w = torch.ones_like(per_ex)
    loss = torch.sum(per_ex * w) / torch.clamp_min(torch.sum(w), 1e-9)
    return loss, {"loss": loss, "per_example": per_ex}
