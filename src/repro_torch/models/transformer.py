"""Decoder-only LM: the layer layout, parameter init, the forward and the
weighted-example loss for attention, Mamba2, RWKV-6 and hybrid stacks,
with a dense SwiGLU or an MoE FFN (``models/moe.py``) in the attention
blocks.

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
forward does.

``init_cache`` / ``decode_step`` are the decode path with a contiguous
cache (the static ``launch.serve.generate``; continuous serving runs its
own step, ``serve.paged``): the reference's cache tree, per segment, and
a chunk of T >= 1 tokens at positions ``pos..pos+T-1`` against it.
``decode_step`` writes the new keys, values and recurrent states into the
caller's cache tensors in place and returns that same tree.  Its
attention (``decode_attention_dyn``) runs on the CPU the reference's
einsum form line for line; on the card a one-token step launches B5 on
each layer's cache where it lies, and a chunk (T > 1) B4 with the query
offset ``pos`` over a copy of the first ``pos + T`` keys.  Mamba2 and
RWKV-6 segments step one token (T = 1) in plain PyTorch on every device,
as the reference's ``jnp`` steps do.
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
from repro_torch.models.moe import moe_ffn
from repro_torch.models.shard_ctx import lookup, write_rows
from repro_torch.models.attention import (NEG_INF, attention_block,
                                         attn_project_qkv, chunked_attention,
                                         decode_attention, gqa_expand)
from repro_torch.models.layers import (MetaDraws, chunked_cross_entropy,
                                      cross_entropy, dropout, dtype_of,
                                      normal_init, rms_norm, rope_tables,
                                      swiglu)


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
    its own device (the reference's ``normal_init``); a ``MetaDraws``
    goes to ``layers.normal_init``, which owns the meta route."""
    if isinstance(gen, MetaDraws):
        return normal_init(gen, shape, scale, dtype, gen.device)
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


def _init_moe(gen, cfg, dtype, lead=()):
    """The MoE FFN's parameters: the router in f32 whatever ``dtype``,
    ``padded_experts`` experts (router-masked padding included)."""
    e, d = cfg.moe, cfg.d_model
    ne, f = e.padded_experts, e.d_ff_expert
    p = {
        "router": _normal(gen, (*lead, d, ne), d ** -0.5, torch.float32),
        "wi": _normal(gen, (*lead, ne, d, f), d ** -0.5, dtype),
        "wg": _normal(gen, (*lead, ne, d, f), d ** -0.5, dtype),
        "wo": _normal(gen, (*lead, ne, f, d), f ** -0.5, dtype),
    }
    if e.dense_residual:
        mlp = _init_mlp(gen, cfg, dtype, lead)
        p.update({"res_wi": mlp["wi"], "res_wg": mlp["wg"],
                  "res_wo": mlp["wo"]})
    return p


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
    p = {"ln1": zeros(),
         "attn": _init_attn_layer(gen, cfg, dtype, lead),
         "ln2": zeros()}
    if cfg.moe:
        p["moe"] = _init_moe(gen, cfg, dtype, lead)
    else:
        p["mlp"] = _init_mlp(gen, cfg, dtype, lead)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None):
    """The full parameter tree on ``device`` (``None`` means the card),
    drawn from ``gen``, which must live on that device: the reference's
    shapes, scales and dtypes (``param_dtype`` weights, f32 norms), not
    its bits.  ``models.layers.MetaDraws`` with ``device="meta"`` builds
    the shapes and dtypes alone."""
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
def _ffn(p, hin, cfg, dropless: bool = False):
    """The block's FFN on the normed ``hin``: (y, the layer's aux loss —
    a tensor for MoE blocks, 0.0 for dense ones)."""
    if cfg.moe:
        return moe_ffn(p["moe"], hin, cfg.moe, dropless=dropless)
    return swiglu(hin, p["mlp"]["wi"], p["mlp"]["wg"], p["mlp"]["wo"]), 0.0


def _attn_block_body(p, x, cfg, window, positions, drop_seed, drop_rate,
                     train):
    """(the block's output, its aux loss)."""
    h = x + attention_block(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                            cfg, window=window, positions=positions,
                            train=train)
    y, aux = _ffn(p, rms_norm(h, p["ln2"], cfg.norm_eps), cfg)
    return h + dropout(y, _layer_gen(x.device, drop_seed), drop_rate), aux


def _mamba_block_body(p, x, cfg, train):
    return x + m2.mamba2_block(p["mamba"], rms_norm(x, p["ln1"],
                                                    cfg.norm_eps), cfg,
                               train=train), 0.0


def _rwkv_block_body(p, x, cfg, train):
    y, _, _ = rk.time_mix(p["rwkv"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                          train=train)
    h = x + y
    y, _ = rk.channel_mix(p["rwkv"], rms_norm(h, p["ln2"], cfg.norm_eps), cfg)
    return h + y, 0.0


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
    """``body(x)`` (a block's (output, aux loss)) under the config's remat
    policy (only where a backward will run)."""
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
    ``return_hidden``) [, the aux load-balance loss summed over the MoE
    layers: 0.0 without MoE].

    embeddings: optional (B, S, D) — overrides the token embedding.
    drop_rng: a ``torch.Generator`` whose seed keys every attention
    block's dropout (at ``drop_rate``) on the MLP output, per layer.
    train: run the differentiable scans in place of B4 / B7 / B8 on the
    card (the training forward; see the module docstring)."""
    cdt = dtype_of(cfg.compute_dtype)
    if embeddings is None:
        x = lookup(params["embed"], tokens).to(cdt)
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

    aux_total = 0.0
    li = 0
    for seg, sp in zip(layout(cfg), params["segments"]):
        if seg.kind == SHARED_ATTN:
            x, aux = _remat(cfg, attn(params["shared"], 0, li), x)
            aux_total = aux_total + aux
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
            x, aux = _remat(cfg, body, x)
            aux_total = aux_total + aux
        li += seg.count

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    if return_hidden:
        out = x
    else:
        head = params.get("lm_head", params["embed"])
        out = torch.einsum("bsd,vd->bsv", x, head)
    return (out, aux_total) if return_aux else out


def loss_fn(params, cfg: ModelConfig, batch, *, drop_rng=None,
            drop_rate: float = 0.0):
    """Weighted-example LM loss — the dual-batch hook.

    batch: {"tokens": (B, S), "labels": (B, S), optional "weight": (B,)
    per-example contribution (model-update factor x validity mask; see
    ``core/spmd_dual_batch.py``), optional "embeddings": (B, S, D)}.
    Runs the training forward (``train=True``), and for a vocabulary of
    65536 or more the chunked CE, which never makes the (B, S, V) f32
    logits.  An MoE model adds ``router_aux_weight`` times its aux loss
    per layer.  Returns (loss, {"loss", "per_example"})."""
    fw = dict(drop_rng=drop_rng, drop_rate=drop_rate,
              embeddings=batch.get("embeddings"), return_aux=True,
              train=True)
    if cfg.vocab_size >= 65536:
        hidden, aux = forward(params, cfg, batch["tokens"],
                              return_hidden=True, **fw)
        head = params.get("lm_head", params["embed"])
        per_ex = chunked_cross_entropy(hidden, head, batch["labels"])
    else:
        logits, aux = forward(params, cfg, batch["tokens"], **fw)
        per_ex = cross_entropy(logits, batch["labels"])        # (B,)
    w = batch.get("weight")
    if w is None:
        w = torch.ones_like(per_ex)
    loss = torch.sum(per_ex * w) / torch.clamp_min(torch.sum(w), 1e-9)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux / max(cfg.n_layers, 1)
    return loss, {"loss": loss, "per_example": per_ex}


# --------------------------- decode -----------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None):
    """Per-segment cache tree for decode, on ``device`` (``None`` means
    the card): the reference's tree and shapes — attention ``k``/``v``
    ``(count, B, max_seq, KV, hd)`` (``(1, ...)`` for each call of the
    shared block) in ``dtype`` (the compute dtype when None), Mamba2 ``h``
    ``(count, B, nh, P, N)`` f32 and ``conv`` ``(count, B, d_conv-1,
    d_in+2N)``, RWKV-6 ``wkv`` ``(count, B, H, hd, hd)`` f32 and
    ``shift_t`` / ``shift_c`` ``(count, B, 1, D)``; all zeros."""
    device = resolve_device(device)
    dtype = dtype or dtype_of(cfg.compute_dtype)
    zeros = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt,
                                                device=device)
    caches = []
    for seg in layout(cfg):
        if seg.kind in (ATTN, SHARED_ATTN):
            n = seg.count if seg.kind == ATTN else 1
            shape = (n, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
            caches.append({"k": zeros(shape), "v": zeros(shape)})
        elif seg.kind == MAMBA2:
            sc = cfg.ssm
            d_in = sc.expand * cfg.d_model
            nh = d_in // sc.head_dim
            caches.append({
                "h": zeros((seg.count, batch, nh, sc.head_dim, sc.d_state),
                           torch.float32),
                "conv": zeros((seg.count, batch, sc.d_conv - 1,
                               d_in + 2 * sc.d_state))})
        elif seg.kind == RWKV6:
            h, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
            caches.append({
                "wkv": zeros((seg.count, batch, h, hd, hd), torch.float32),
                "shift_t": zeros((seg.count, batch, 1, d)),
                "shift_c": zeros((seg.count, batch, 1, d))})
        else:
            raise ValueError(seg.kind)
    return caches


def decode_attention_dyn(q, k_cache, v_cache, pos, window: int):
    """Attention of a chunk of T >= 1 query tokens at positions
    pos..pos+T-1 over a ``(B, S, KV, hd)`` cache that already holds them
    (T = 1 is the classic single-token decode; T > 1 the chunked prefill
    — causality within the chunk falls out of the same position mask).
    ``window``: this layer's sliding window (0 = global).  ``pos``: a host
    int, or a 0-d int32 tensor on q's device (the reference's traced
    position).

    On the CPU the reference's einsum form, line for line (f32 scores,
    softmax and product).  On the card T = 1 is B5 and T > 1 B4 with
    ``q_offset = pos``, each over the whole cache as it lies (its
    ``transpose(1, 2)`` view, no slice and no copy) with ``pos`` read
    where it is: the causal mask drops the keys past ``pos + T - 1``, and
    the kernels load no tile it would drop."""
    b, t, h, hd = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    if q.device.type != "cpu":
        if t == 1:
            return decode_attention(q, k_cache, v_cache, pos, window=window)
        if k_cache.dtype != q.dtype:
            # B4 takes one dtype: a cache kept in another (an f32 cache
            # behind a bf16 model) is cast, as the reference reads it in
            # f32, and q with it; at a host pos only the first pos + T
            # keys, at a tensor pos the whole cache
            n = s if isinstance(pos, torch.Tensor) else pos + t
            return chunked_attention(q.float(), k_cache[:, :n].float(),
                                     v_cache[:, :n].float(), window=window,
                                     q_offset=pos).to(q.dtype)
        return chunked_attention(q, k_cache, v_cache, window=window,
                                 q_offset=pos)
    n_rep = h // kvh
    k = gqa_expand(k_cache, n_rep).float()
    v = gqa_expand(v_cache, n_rep).float()
    qf = q.float() * hd ** -0.5
    scores = torch.einsum("bqhd,bshd->bhqs", qf, k)
    idx = torch.arange(s, device=q.device)
    qpos = pos + torch.arange(t, device=q.device)               # (T,)
    valid = idx[None, :] <= qpos[:, None]                       # (T, S)
    if window > 0:
        valid = torch.logical_and(valid,
                                  idx[None, :] > qpos[:, None] - window)
    scores = torch.where(valid[None, None, :, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", p, v).to(q.dtype)


def _decode_attn_layer(p, x, cfg, cache_k, cache_v, window, pos, rope,
                       slot):
    """One attention block over a chunk; writes its keys and values into
    ``cache_k`` / ``cache_v`` (``(B, S, KV, hd)`` views) at ``pos`` — for
    a tensor ``pos`` at ``slot``, its int64 index on the same device."""
    b, t = x.shape[:2]
    xin = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attn_project_qkv(p["attn"], xin, None, cfg, rope=rope)
    _cache_write(cache_k, cache_v, k, v, pos, slot)
    o = decode_attention_dyn(q, cache_k, cache_v, pos, window)
    h = x + o.reshape(b, t, cfg.n_heads * cfg.head_dim) @ p["attn"]["wo"]
    y, _ = _ffn(p, rms_norm(h, p["ln2"], cfg.norm_eps), cfg, dropless=True)
    return h + y


def _cache_slot(pos, t: int, max_seq: int):
    """The cache write's T indices for a tensor ``pos`` (int64, on its
    device: the start clamped to ``[0, max_seq - T]`` as the reference's
    ``dynamic_update_slice`` clamps it, while RoPE and the mask read the
    unclamped ``pos``); None for a host int, which must fit the chunk in
    the cache."""
    if t > max_seq:
        raise ValueError(f"a chunk of {t} does not fit a cache of {max_seq} "
                         "positions")
    if isinstance(pos, torch.Tensor):
        return pos.clamp(0, max_seq - t).long() + torch.arange(
            t, device=pos.device)
    if pos + t > max_seq:
        raise ValueError(f"a chunk of {t} at position {pos} does not fit "
                         f"a cache of {max_seq} positions")
    return None


def _cache_write(cache_k, cache_v, k, v, pos, slot):
    """Write a chunk's keys and values into ``(B, S, KV, hd)`` caches at
    ``pos`` (at ``slot`` for a tensor ``pos``), in place; on a mesh that
    shards the positions, each rank writes its own shard
    (``write_rows``)."""
    if slot is None:
        t = k.shape[1]
        cache_k[:, pos:pos + t] = k.to(cache_k.dtype)
        cache_v[:, pos:pos + t] = v.to(cache_v.dtype)
    else:
        write_rows(cache_k, 1, slot, k.to(cache_k.dtype))
        write_rows(cache_v, 1, slot, v.to(cache_v.dtype))


def _pos_arg(pos, device):
    """``decode_step``'s ``pos``: a host int >= 0, or a 0-d integer tensor
    on ``device``, returned as int32 (B4 and B5 read int32)."""
    if isinstance(pos, torch.Tensor):
        if pos.dim() != 0 or pos.dtype.is_floating_point or \
                pos.dtype.is_complex or pos.dtype == torch.bool or \
                pos.device != device:
            raise ValueError(f"a tensor pos must be a 0-d integer tensor on "
                             f"{device}, got {tuple(pos.shape)} {pos.dtype} "
                             f"on {pos.device}")
        return pos.to(torch.int32)
    if isinstance(pos, bool) or int(pos) != pos or pos < 0:
        raise ValueError(f"pos must be an int >= 0 or a 0-d integer tensor, "
                         f"got {pos!r}")
    return int(pos)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, caches, tokens, pos, *,
                embeddings=None):
    """Decode a chunk of T >= 1 tokens against the cache.

    tokens: (B, T) int; pos: the cache position of the FIRST new token
    (the chunk occupies pos..pos+T-1), a host int, or a 0-d integer
    tensor on the tokens' device — the reference's traced
    ``jnp.int32(pos)``: the cache write, RoPE, B4 and B5 then read it on
    the device, with no copy to the host, so the caller keeps ``pos >= 0``
    (the write's start is clamped to ``[0, max_seq - T]``, as the
    reference's ``dynamic_update_slice`` clamps it, while RoPE and the
    mask take ``pos`` as it is; a host int past the cache raises).  T = 1
    is the classic one-token decode step; T > 1 is the
    batched or chunked prefill of attention stacks.  Recurrent segments
    (mamba2 / rwkv6) accept only T = 1, as the reference's do.
    embeddings: optional (B, T, D) in place of the token embedding.

    Writes the chunk's keys, values and states into ``caches`` in place
    and returns (logits (B, T, V) in the compute dtype, ``caches``)."""
    cdt = dtype_of(cfg.compute_dtype)
    if embeddings is None:
        x = lookup(params["embed"], tokens).to(cdt)
    else:
        x = embeddings.to(cdt)
    b, t = x.shape[:2]
    pos = _pos_arg(pos, x.device)
    segs = layout(cfg)
    rope = slot = None
    if any(seg.kind in (ATTN, SHARED_ATTN) for seg in segs):
        max_seq = next(c["k"].shape[2] for seg, c in zip(segs, caches)
                       if seg.kind in (ATTN, SHARED_ATTN))
        slot = _cache_slot(pos, t, max_seq)
        # one set of RoPE tables for every layer (the reference builds
        # the same values in each)
        positions = (pos + torch.arange(t, device=x.device)).expand(b, t)
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    for seg, sp, cache in zip(segs, params["segments"], caches):
        if seg.kind == SHARED_ATTN:
            x = _decode_attn_layer(params["shared"], x, cfg, cache["k"][0],
                                   cache["v"][0], 0, pos, rope, slot)
            continue
        if seg.kind in (MAMBA2, RWKV6) and t != 1:
            raise ValueError(f"chunked decode (T>1) requires attention "
                             f"segments; {seg.kind} decode steps one token")
        for i, p in enumerate(_layers(sp, seg.count)):
            if seg.kind == ATTN:
                x = _decode_attn_layer(p, x, cfg, cache["k"][i],
                                       cache["v"][i], seg.windows[i], pos,
                                       rope, slot)
            elif seg.kind == MAMBA2:
                xin = rms_norm(x, p["ln1"], cfg.norm_eps)
                y, st = m2.mamba2_decode(p["mamba"], xin, cfg,
                                         {"h": cache["h"][i],
                                          "conv": cache["conv"][i]})
                x = x + y
                cache["h"][i].copy_(st["h"])
                cache["conv"][i].copy_(st["conv"])
            elif seg.kind == RWKV6:
                xin = rms_norm(x, p["ln1"], cfg.norm_eps)
                y, _, wkv = rk.time_mix(
                    p["rwkv"], xin, cfg, shift_state=cache["shift_t"][i],
                    wkv_state=cache["wkv"][i], decode=True)
                h = x + y
                hin = rms_norm(h, p["ln2"], cfg.norm_eps)
                y2, _ = rk.channel_mix(p["rwkv"], hin, cfg,
                                       shift_state=cache["shift_c"][i])
                x = h + y2
                cache["wkv"][i].copy_(wkv)
                cache["shift_t"][i].copy_(xin[:, -1:])
                cache["shift_c"][i].copy_(hin[:, -1:])
            else:
                raise ValueError(seg.kind)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head", params["embed"])
    return torch.einsum("bsd,vd->bsv", x, head), caches
