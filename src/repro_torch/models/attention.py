"""GQA attention pieces the serving slice needs: the masked-score constant,
head repetition and the q/k/v projection with RoPE.

The reference's training/prefill scan (``chunked_attention``) and its
decode path (``decode_attention``) wait for the LM slice (ROADMAP A12);
the paged serve step has its own attention math (``serve.paged``).
"""
from __future__ import annotations

import torch

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
