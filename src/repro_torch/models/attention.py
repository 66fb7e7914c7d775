"""GQA attention: the prefill path (``chunked_attention`` and the
self- and cross-attention sublayers built on it), head repetition and the
q/k/v projection with RoPE.

``chunked_attention`` has two forms.  For CUDA tensors, when the keys
are the queries' own (causal, ``q_offset == 0``, ``sq == sk``) or the
attention is not causal, it launches the hand-written kernel B4
(``kernels.flash_attention``) on ``(B, H, S, hd)`` copies of q, k and v;
a causal call with an offset raises there (B4 places queries and keys
from 0; attention behind a cache comes with ROADMAP A12).  On the CPU,
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

The paged serve step has its own decode math (``serve.paged``); the
reference's ``decode_attention`` waits for the decode slice (ROADMAP
A14).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.models.layers import apply_rope

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
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, kvh, hd)
    v = (x @ p["wv"]).reshape(b, s, kvh, hd)
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
    Returns (B, Sq, H, hd) in q's dtype.  Off the CPU this is B4, which
    takes the keys as the queries' own or the attention as not causal,
    unless ``train`` asks for the differentiable scan (see the module
    docstring)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    window = int(window)
    if q.device.type != "cpu" and not train:
        if causal and (q_offset != 0 or sq != sk):
            raise NotImplementedError(
                "causal attention with a query offset (q_offset "
                f"{q_offset}, sq {sq}, sk {sk}) runs only on the CPU: B4 "
                "places queries and keys from 0; attention behind a cache "
                "comes with ROADMAP A12")
        t = lambda a: a.transpose(1, 2).contiguous()
        o = _fa.flash_attention(t(q), t(k), t(v), causal=causal,
                                window=window)
        return o.transpose(1, 2)
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


def cross_attention_block(p, x, enc_kv, cfg):
    """Cross-attention for enc-dec: queries from x, keys and values
    projected here from the encoder activations enc_kv (B, Senc, D)."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    senc = enc_kv.shape[1]
    k = (enc_kv @ p["wk"]).reshape(b, senc, kvh, hd)
    v = (enc_kv @ p["wv"]).reshape(b, senc, kvh, hd)
    o = chunked_attention(q, k, v, causal=False)
    return o.reshape(b, s, h * hd) @ p["wo"]
