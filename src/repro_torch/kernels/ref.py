"""Plain-PyTorch oracles (the reference's ``kernels/ref.py``): the
dual-batch merge and the decode attention."""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map

NEG_INF = -1e30


def dbl_merge_ref(p, g_large, g_small, *, factor, lr):
    """Paper §3.4 server update, fused-form oracle:
    w' = w − lr·(g_L + f·g_S)/(1 + f)."""
    gl = g_large.float()
    gs = g_small.float()
    step = (gl + factor * gs) / (1.0 + factor)
    return (p.float() - lr * step).to(p.dtype)


def dbl_merge_unfused(p, g_large, g_small, *, factor, lr):
    """The naive scale/add/normalize/apply sequence over trees, each
    intermediate materialized (eager PyTorch materializes every op) — the
    parameter-sized round trips the fused kernel removes."""
    merged = tree_map(lambda gl, gs: gl.float() + factor * gs.float(),
                      g_large, g_small)
    step = tree_map(lambda m: m * (1.0 / (1.0 + factor)), merged)
    return tree_map(lambda w, s: (w.float() - lr * s).to(w.dtype), p, step)


def flash_decode_ref(q, k_cache, v_cache, pos, *, window=0):
    """q: (B,H,1,hd); caches (B,KV,S,hd); pos scalar -> (B,H,1,hd).
    Softmax of the NEG_INF-masked scores in f32, cast to q's dtype."""
    b, h, _, hd = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    k = torch.repeat_interleave(k_cache, h // kvh, dim=1)
    v = torch.repeat_interleave(v_cache, h // kvh, dim=1)
    sc = torch.einsum("bhqd,bhsd->bhqs", q.float(), k.float()) * hd ** -0.5
    idx = torch.arange(s, device=q.device)
    valid = idx <= pos
    if window > 0:
        valid = torch.logical_and(valid, idx > pos - window)
    sc = torch.where(valid[None, None, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqs,bhsd->bhqd", p, v.float()).to(q.dtype)
