"""Plain-PyTorch oracles (the reference's ``kernels/ref.py``): the
dual-batch merge, the prefill and decode attention, and the per-step SSD
and WKV6 recurrences.  Each keeps the reference oracle's own layout."""
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


def flash_attention_ref(q, k, v, *, causal=True, window=0, q_offset=0):
    """q: (B,H,Sq,hd); k,v: (B,KV,Sk,hd) -> (B,H,Sq,hd). Naive softmax of
    the NEG_INF-masked f32 scores (query i at position q_offset + i, keys
    from 0; the reference's oracle has q_offset 0), cast to q's dtype."""
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    n_rep = h // kvh
    k = torch.repeat_interleave(k, n_rep, dim=1)
    v = torch.repeat_interleave(v, n_rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * hd ** -0.5
    if causal:
        qp = q_offset + torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(sk, device=q.device)[None, :]
        mask = qp >= kp
        if window > 0:
            mask = torch.logical_and(mask, qp - kp < window)
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def ssd_scan_ref(x, dt, A_log, B, C, D_skip):
    """Naive per-step SSD recurrence (oracle for the chunked forms).

    x: (Bt,S,H,P); dt: (Bt,S,H); A_log: (H,); B,C: (Bt,S,N); D_skip: (H,).
    Returns y (Bt,S,H,P) in x's dtype and the final state (Bt,H,P,N) f32.
    """
    bt, s, h, p = x.shape
    n = B.shape[-1]
    a = -torch.exp(A_log.float())
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    hstate = torch.zeros((bt, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        alpha = torch.exp(dtf[:, t] * a)                          # (Bt,H)
        upd = torch.einsum("bhp,bn->bhpn", xf[:, t] * dtf[:, t, :, None],
                           Bf[:, t])
        hstate = hstate * alpha[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", hstate, Cf[:, t]))
    y = torch.stack(ys, dim=1)
    y = y + xf * D_skip.float()[None, None, :, None]
    return y.to(x.dtype), hstate


def wkv6_ref(r, k, v, w, u, state=None, out_dtype=None):
    """Naive WKV6 recurrence. r,k,w: (B,S,H,K); v: (B,S,H,V); u: (H,K);
    state: the initial (B,H,K,V) f32 state, zero when None.
    Returns y (B,S,H,V) in ``out_dtype`` (r's dtype when None) and the
    final state (B,H,K,V) f32."""
    b, s, h, kd = r.shape
    vd = v.shape[-1]
    S = state if state is not None else torch.zeros(
        (b, h, kd, vd), dtype=torch.float32, device=r.device)
    uf = u.float()[None, :, :, None]
    rf, kf, vf, wf = r.float(), k.float(), v.float(), w.float()
    ys = []
    for t in range(s):
        kv = torch.einsum("bhk,bhv->bhkv", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], S + uf * kv))
        S = S * wf[:, t, ..., None] + kv
    return torch.stack(ys, dim=1).to(out_dtype or r.dtype), S


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
