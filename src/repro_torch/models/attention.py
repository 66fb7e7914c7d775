"""GQA attention: the prefill path (``chunked_attention`` and the
self- and cross-attention sublayers built on it), the single-token decode
path (``decode_attention``), head repetition and the q/k/v projection
with RoPE.

``chunked_attention`` has two forms.  For CUDA tensors it launches the
hand-written kernel B4 (``kernels.flash_attention``) on ``(B, H, S,
hd)`` copies of q, k and v, query ``i`` at position ``q_offset + i``
(the prefill's ``q_offset = 0``; a chunk behind a KV cache passes its
position, ``models.transformer.decode_attention_dyn``).  On the CPU,
and on any device when the caller asks for the training form
(``train=True``: B4 has no backward), it runs the port of the
reference's XLA scan, line for line, under autograd: an online
softmax over KV blocks
of ``block_k`` with ``q·scale`` in the compute dtype, f32 scores and
``p`` cast to v's dtype before the product with v.  B4 computes the
reference's Pallas semantics instead: ``q·scale``, the scores, ``p`` and
the product with v all in f32.  In f32 the two agree to a few 1e-5
(``tests/test_kernels.py`` holds the reference's two forms to 3e-5); in
bf16 on the card the model therefore computes with f32 scores and f32
``p`` where the reference's scan rounds ``q·scale`` and ``p`` to bf16.

``decode_attention`` is one query token over a ``(B, S, KV, hd)``
cache: on the CPU the reference's einsum form line for line (f32 scores
and softmax), on the card the kernel B5 (``kernels.flash_decode``),
which reads the cache where it lies.  On a mesh both kernels run on
each rank's own batch rows and heads.  The paged serve step has its own
decode math (``serve.paged``).
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.core.dtensor import is_dtensor
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.launch.hlo_analysis import fused
from repro_torch.models.layers import apply_rope
from repro_torch.models.shard_ctx import (constrain, on_rank_shards,
                                         split_heads)

NEG_INF = -1e30


def gqa_expand(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*n_rep, hd) by head repetition."""
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd) \
            .reshape(b, s, kv * n_rep, hd)


def attn_project_qkv(p, x, positions, cfg, *, rope=None):
    """q (B, S, H, hd), k and v (B, S, KV, hd) with RoPE on q and k.
    ``rope``: ``layers.rope_tables(positions, hd, theta)``, when the caller
    holds them for several layers."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(x @ p["wq"], (b, s, h, hd))
    k = split_heads(x @ p["wk"], (b, s, kvh, hd))
    v = split_heads(x @ p["wv"], (b, s, kvh, hd))
    q = apply_rope(q, positions, cfg.rope_theta, tables=rope)
    k = apply_rope(k, positions, cfg.rope_theta, tables=rope)
    return q, k, v


def _block_mask(q_pos, k_pos, window: int):
    """Causal + optional sliding-window mask."""
    diff = q_pos[:, None] - k_pos[None, :]
    m = diff >= 0
    if window > 0:
        m = torch.logical_and(m, diff < window)
    return m


def chunked_attention(q, k, v, *, window: int = 0, causal: bool = True,
                      block_k: int = 1024, q_offset: int = 0,
                      train: bool = False):
    """Flash-style attention with online softmax over KV blocks.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H % KV == 0.
    window: 0 (global) or a sliding window (applies when causal).
    q_offset: the position of query 0 (keys count from 0), a host int or,
    off the CPU, a 0-d int32 tensor on q's device that B4 reads there.
    Returns (B, Sq, H, hd) in q's dtype.  Off the CPU this is B4, unless
    ``train`` asks for the differentiable scan (see the module
    docstring)."""
    if is_dtensor(q):
        # on a mesh, each rank attends over its own batch rows and heads:
        # the reference's "bh.." constraints on q, k and v (its
        # attention.py:70-73) as the local shards' placements
        return on_rank_shards(partial(chunked_attention, window=window,
                                      causal=causal, block_k=block_k,
                                      q_offset=q_offset, train=train),
                              (q, k, v), ("b.h.",) * 3, "b.h.")
    window = int(window)
    if q.device.type != "cpu" and not train:
        # B4 reads k and v through their (B, KV, Sk, hd) views as they lie
        # (a layer cache, the projections), q and its output contiguous
        kv = (a.transpose(1, 2) for a in (k, v))
        kv = [a if _fa.readable(a) else a.contiguous() for a in kv]
        o = _fa.flash_attention(q.transpose(1, 2).contiguous(), *kv,
                                causal=causal, window=window,
                                q_offset=q_offset)
        return o.transpose(1, 2)
    # B4's work in its plain form: a cost count keeps the scan's scores
    # and probabilities out of its device-memory bytes
    return fused(_attention_scan, q, k, v, window=window, causal=causal,
                 block_k=block_k, q_offset=q_offset)


def _attention_scan(q, k, v, *, window, causal, block_k, q_offset):
    """The reference's XLA scan (``chunked_attention``'s plain form)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    n_rep = h // kv
    k = gqa_expand(k, n_rep)
    v = gqa_expand(v, n_rep)

    block_k = min(block_k, sk)
    nkb = sk // block_k
    rem = sk - nkb * block_k
    scale = hd ** -0.5

    # q·scale rounds in the compute dtype; the dots take f32 operands (a
    # bf16 product is exact in f32), the reference's
    # preferred_element_type=f32
    qf = (q * scale).transpose(1, 2).float()                    # (B,H,Sq,hd)
    kf = k.transpose(1, 2)                                      # (B,H,Sk,hd)
    vf = v.transpose(1, 2)
    q_pos = q_offset + torch.arange(sq, device=q.device)

    def attend_block(carry, kb, vb, k_pos):
        m_prev, l_prev, acc = carry
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb.float())      # (B,H,Sq,bk)
        if causal:
            mask = _block_mask(q_pos, k_pos, window)
            s = torch.where(mask[None, None], s, NEG_INF)
        m_cur = torch.maximum(m_prev, s.amax(dim=-1))
        alpha = torch.exp(m_prev - m_cur)
        p = torch.exp(s - m_cur[..., None])
        l_new = l_prev * alpha + p.sum(dim=-1)
        # AV with p in the value dtype, f32 accumulation
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(vb.dtype).float(), vb.float())
        return m_cur, l_new, acc

    dev = q.device
    carry = (torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev),
             torch.zeros((b, h, sq), dtype=torch.float32, device=dev),
             torch.zeros((b, h, sq, hd), dtype=torch.float32, device=dev))
    for j in range(nkb):
        sl = slice(j * block_k, (j + 1) * block_k)
        carry = attend_block(carry, kf[:, :, sl], vf[:, :, sl],
                             torch.arange(sl.start, sl.stop, device=dev))
    if rem:
        carry = attend_block(carry, kf[:, :, nkb * block_k:],
                             vf[:, :, nkb * block_k:],
                             torch.arange(nkb * block_k, sk, device=dev))
    _, l, acc = carry
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.transpose(1, 2).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0):
    """Single-token decode attention over a KV cache.

    q: (B, 1, H, hd); k_cache/v_cache: (B, S, KV, hd); pos: the number of
    tokens already in the cache, i.e. the new token's index — a host int,
    or a 0-d int32 tensor on q's device (the reference's traced position),
    which B5 reads on the card.  window: if > 0, attend only to the last
    ``window`` keys.  On CUDA tensors this is B5 on the caches as they lie;
    on the CPU the reference's einsum form (f32 scores, softmax and
    product), the same bits for either form of ``pos``."""
    if q.device.type != "cpu":
        # on a mesh each rank attends over its own batch rows and heads
        t = lambda a: a.transpose(1, 2)
        return on_rank_shards(
            lambda q, k, v: t(_fd.flash_decode(t(q), t(k), t(v), pos,
                                               window=window)),
            (q, k_cache, v_cache), ("b.h.",) * 3, "b.h.")
    return fused(_decode_einsum, q, k_cache, v_cache, pos, window=window)


def _decode_einsum(q, k_cache, v_cache, pos, *, window):
    """The reference's einsum form (``decode_attention``'s plain form)."""
    b, _, h, hd = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    n_rep = h // kvh
    k = constrain(gqa_expand(k_cache, n_rep).float(), "b.h.")
    v = constrain(gqa_expand(v_cache, n_rep).float(), "b.h.")
    qf = constrain(q.float() * hd ** -0.5, "b.h.")
    scores = torch.einsum("bqhd,bshd->bhqs", qf, k)       # (B,H,1,S)
    idx = torch.arange(s, device=q.device)
    valid = idx <= pos
    if window > 0:
        valid = torch.logical_and(valid, idx > pos - window)
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", p, v)
    return out.to(q.dtype)


def attention_block(p, x, cfg, *, window: int = 0, positions=None,
                    block_k: int = 1024, train: bool = False):
    """Full self-attention sublayer (no norm/residual); ``train`` selects
    the differentiable scan on the card (``chunked_attention``)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = attn_project_qkv(p, x, positions, cfg)
    o = chunked_attention(q, k, v, window=window, block_k=block_k,
                          train=train)
    return o.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"]


def cross_attention_block(p, x, enc_kv, cfg, *, train: bool = False):
    """Cross-attention for enc-dec: queries from x, keys and values
    projected here from the encoder activations enc_kv (B, Senc, D), no
    RoPE and no mask (``chunked_attention(causal=False)``: B4's
    non-causal form on the card, at any number of queries, one in a
    decode step); ``train`` selects the differentiable scan on the card,
    as ``attention_block``'s does."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(x @ p["wq"], (b, s, h, hd))
    senc = enc_kv.shape[1]
    k = (enc_kv @ p["wk"]).reshape(b, senc, kvh, hd)
    v = (enc_kv @ p["wv"]).reshape(b, senc, kvh, hd)
    o = chunked_attention(q, k, v, causal=False, train=train)
    return o.reshape(b, s, h * hd) @ p["wo"]
