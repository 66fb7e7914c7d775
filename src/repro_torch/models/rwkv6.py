"""RWKV-6 (Finch) block: time-mix with data-dependent decay and
channel-mix, over a whole sequence (prefill) or one token from a state
(decode).

``wkv6_scan`` is the reference's scan over time (the WKV recurrence) in
its chunks: the pairs of tokens within each chunk as a few batched
products, checkpointed ``PAIR_TOKENS`` tokens at a time, and the state
stepped once a chunk, so the backward keeps one state a chunk as the
reference's does.  On CUDA tensors ``time_mix`` launches the
hand-written kernel B8 (``kernels.wkv6``) instead, on the
``(B, H, S, ·)`` views of its ``(B, S, H, ·)`` projections as they are
(r, k, v in the model's dtype, the decay w in f32) and with an f32
output, as the reference's scan returns f32; the kernel writes y in
``(B, S, H, V)`` memory, so the per-head group norm reads it without a
copy, and nothing is cast or transposed around B8.  On the CPU
``time_mix`` runs ``wkv6_scan``, from a given state too, and so it does
on any device when the caller asks for the training form
(``train=True``: B8 has no backward), under autograd; on the card a
given state raises (no reference path runs a whole sequence from a
state).  The one-token decode step (``wkv6_step``,
``time_mix(..., decode=True)``) is the reference's plain ``jnp`` step in
PyTorch on every device: one ``(H, K, V)`` state update per token needs
no kernel of its own.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import wkv6 as _wkv
from repro_torch.launch.hlo_analysis import fused
from repro_torch.models.shard_ctx import (constrain, merge_heads,
                                         on_rank_shards, split_heads)


def token_shift(x, shift_state=None):
    """Return previous-token tensor. x: (B, S, D)."""
    if shift_state is None:
        shift_state = torch.zeros_like(x[:, :1])
    return torch.cat([shift_state, x[:, :-1]], dim=1)


def wkv6_scan(r, k, v, w, u, state=None, chunk: int = 64):
    """WKV6 recurrence, chunked so that the backward keeps O(S/chunk)
    states: the reference's ``wkv6_scan`` and its ``chunk`` rule.

    r,k,w: (B,S,H,K); v: (B,S,H,V); u: (H,K) bonus; state: (B,H,K,V).
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    Returns y (B,S,H,V) f32 and the final state.  The sequence goes in
    chunks of ``q`` tokens (``q = min(chunk, S)``, lowered until it
    divides S).  A chunk's pairs of tokens need no state: they are a few
    batched products (``_wkv_pairs``), ``PAIR_TOKENS`` tokens' chunks at a
    time under ``torch.utils.checkpoint``, so their (q, q)-sized
    intermediates are recomputed in the backward, as the reference's
    ``jax.checkpoint`` body recomputes its chunk.  The state then steps
    once a chunk (two products), and autograd keeps the state entering
    each chunk: one state a chunk, as the reference's outer scan keeps.
    The per-token oracle is ``ref.wkv6_ref``.  On a mesh each rank scans
    its own batch rows and heads over the whole sequence."""
    return on_rank_shards(
        lambda r, k, v, w, u, state: _wkv6_chunked(r, k, v, w, u, state,
                                                   chunk),
        (r, k, v, w, u, state),
        ("b.h.",) * 4 + ("h.", None if state is None else "bh.."),
        ("b.h.", "bh.."))


def _chunk_len(s: int, chunk: int) -> int:
    """The reference's chunk length: ``min(chunk, s)``, lowered until it
    divides ``s``."""
    q = min(chunk, s)
    while s % q:
        q -= 1
    return q


def _wkv6_chunked(r, k, v, w, u, state, chunk):
    b, s, h, kd = r.shape
    vd = v.shape[-1]
    if state is None:
        state = torch.zeros((b, h, kd, vd), dtype=torch.float32,
                            device=r.device)
    q = _chunk_len(s, chunk)
    # blocks of a chunk: the largest divisor of q up to SUB
    c = max(d for d in range(1, min(q, SUB) + 1) if q % d == 0)
    n, nc = q // c, s // q
    dev = r.device
    blocks = lambda t: t.float().transpose(1, 2).reshape(
        b, h, nc, n, c, t.shape[-1])               # (B,H,chunk,block,t,·)
    rf, kf, vf = blocks(r), blocks(k), blocks(v)
    lw = blocks(torch.log(w.float().clamp_min(_TINY)))           # <= 0

    # the state-free factors of every chunk at once, each a sum of
    # log-decays over its own segment, so <= 0 (and no short segment
    # behind a long one loses its digits): within a block the decays
    # before token t (a) and after it (z); over the blocks of a chunk the
    # decays before block m and after it, and between two blocks
    lt_c, btw_c, neg_c = _segments(c, dev)
    lt_n, btw_n, neg_n = _segments(n, dev)
    a, z = lt_c @ lw, lt_c.T @ lw                  # (B,H,nc,n,c,K)
    g = lw.sum(4)                                  # (B,H,nc,n,K) block totals
    before, after = lt_n @ g, lt_n.T @ g
    gap = torch.exp(btw_n @ g + neg_n).unflatten(3, (n, n))  # m over p
    # the bonus diagonal, (r_i · (u ⊙ k_i)) v_i
    bonus = (rf * u.float()[None, :, None, None, None, :] * kf).sum(
        -1, keepdim=True) * vf

    # each chunk's operands in the layout its products read, chunk first
    bh = b * h
    first = lambda t, *dims: t.permute(2, *dims).contiguous()
    v_first = first(vf, 0, 1, 3, 4, 5)
    per_chunk = (
        # the carried state: r_i e^{decays since the chunk's start}; the
        # state update: k_j e^{decays until its end}, transposed
        first(rf * torch.exp(a + before.unsqueeze(4)), 0, 1, 3, 4, 5)
        .view(nc, bh, q, kd),
        first(kf * torch.exp(z + after.unsqueeze(4)), 0, 1, 5, 3, 4)
        .view(nc, bh, kd, q),
        v_first.view(nc, bh, q, vd),
        first(torch.exp(g.sum(3)), 0, 1, 3).view(nc, bh, kd, 1),
        # pairs within a block: (t, b·h·block·K) rows
        *(first(t, 4, 0, 1, 3, 5).view(nc, c, -1) for t in (lw, rf, kf)),
        v_first.view(nc, bh * n, c, vd),
        # pairs across blocks: r_i e^{a_i} by (block m, t i), the gaps by
        # (p, m), k_j e^{z_j} by (p, K, j)
        first(rf * torch.exp(a), 0, 1, 3, 4, 5).view(nc, bh, 1, n, c, kd),
        first(gap, 0, 1, 4, 3, 5).view(nc, bh, n, n, 1, kd),
        first(kf * torch.exp(z), 0, 1, 3, 5, 4).view(nc, bh * n, kd, c))

    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, w, u, state))
    # the pairs within each chunk, PAIR_TOKENS tokens' chunks at a time
    group = max(1, PAIR_TOKENS // q)
    pairs = []
    for xs in zip(*(t.split(group) for t in per_chunk[4:])):
        if grad:
            pairs.append(checkpoint(_wkv_pairs, *xs, btw_c, neg_c,
                                    use_reentrant=False))
        else:
            pairs.append(_wkv_pairs(*xs, btw_c, neg_c))
    # the state, stepped once a chunk: S' = diag(e^{Σ lw}) S + Σ_j k̃_j v_jᵀ
    r_st, k_st, v3, total = per_chunk[:4]
    states = [state.reshape(bh, kd, vd)]
    for kt, vt, dt in zip(k_st.unbind(0), v3.unbind(0), total.unbind(0)):
        states.append(torch.baddbmm(dt * states[-1], kt, vt))
    # each chunk's carried state, r_i·diag(e^{Σ_{s<i} lw_s}) S
    y = r_st @ torch.stack(states[:-1]) + torch.cat(pairs)   # (nc,B·H,Q,V)
    y = y.view(nc, b, h, n, c, vd).permute(1, 2, 0, 3, 4, 5) + bonus
    return (y.reshape(b, h, s, vd).transpose(1, 2),
            states[-1].view(b, h, kd, vd))


# block length inside a chunk: pairs of tokens in one block take the
# (c, c, K) tensor of their decays, pairs across blocks three factors,
# each <= 1
SUB = 16
# tokens whose chunks' pairs one checkpointed call computes: bounds the
# (c·c)-sized intermediates it holds at once
PAIR_TOKENS = 512


def _segments(n: int, device):
    """0/1 matrices that sum log-decays over segments of ``n`` steps by a
    product (sums of terms of one sign, which keep their digits): ``lt @
    x`` gives Σ_{s<t} x_s (``lt.T @ x`` Σ_{s>t} x_s), ``btw @ x`` the
    (n·n) rows Σ_{j<s<i} x_s of the pairs (i, j); ``neg`` is 0 where j < i
    and -inf elsewhere, added before an exp so that the other pairs weigh
    0."""
    i = torch.arange(n, device=device)
    lower = i[:, None] > i[None, :]
    btw = (lower[:, None, :] & (i[None, :, None] < i[None, None, :]))
    neg = torch.where(lower, 0.0, float("-inf")).reshape(n * n, 1)
    return lower.float(), btw.float().reshape(n * n, n), neg


def _wkv_pairs(lw, r, k, v, r_in, gap, k_in, btw, neg):
    """The pairs of tokens within each of G chunks, as a few batched
    products: with lw = log w,

      y_i = Σ_{j<i} (Σ_k r_ik e^{Σ_{j<s<i} lw_sk} k_jk) v_j

    (no state; the carried state and the bonus diagonal are added by the
    caller).  Every exponent is a sum of log-decays over a segment, so <=
    0: nothing overflows at decays down to 1e-20 a step.  A chunk is n
    blocks of c tokens.  Pairs within a block take the (c, c, K) tensor of
    their decays, each summed over the pair's own segment: ``lw``, ``r``,
    ``k`` are (G, c, B·H·n·K) and ``v`` (G, B·H·n, c, V).  Pairs across
    blocks m > p factor at the blocks' ends: ``r_in`` (G, B·H, 1, n, c, K)
    is r_i e^{decays in m before i}, ``gap`` (G, B·H, n, n, 1, K)
    e^{decays of the blocks between} by (p, m), ``k_in`` (G, B·H·n, K, c)
    k_j e^{decays in p after j}; each factor <= 1.  Returns y (G, B·H,
    Q, V)."""
    g, bhn, c, vd = v.shape
    bh, n = r_in.shape[1], r_in.shape[3]
    q = n * c
    decay = torch.exp(btw @ lw + neg)                   # (G, c·c, B·H·n·K)
    pair = (r[:, :, None] * k[:, None]).view(g, c * c, -1) * decay
    att = pair.view(g, c, c, bhn, -1).sum(-1).permute(0, 3, 1, 2)
    v = v.reshape(g * bhn, c, vd)
    y = (att.reshape(g * bhn, c, c) @ v).view(g, bh, q, vd)
    if n > 1:
        cross = (r_in * gap).view(g * bhn, q, -1) @ k_in.reshape(
            g * bhn, -1, c)                                   # (·p, Q, c)
        y = y + (cross @ v).view(g, bh, n, q, vd).sum(2)
    return y


# the log of a decay that underflowed to 0 (an f32 w is never below this
# otherwise): keeps lw finite, so no 0·inf reaches the sums or the grads
_TINY = torch.finfo(torch.float32).tiny


def wkv6_step(S, r, k, v, w, u):
    """Single decode step. r,k,w: (B,H,K); v: (B,H,V); S: (B,H,K,V) f32.
    Returns y (B,H,V) f32 and the new state; on a mesh each rank steps
    its own batch rows and heads."""
    return on_rank_shards(_wkv6_step, (S, r, k, v, w, u),
                          ("bh..", "bh.", "bh.", "bh.", "bh.", "h."),
                          ("bh.", "bh.."))


def _wkv6_step(S, r, k, v, w, u):
    kv = torch.einsum("bhk,bhv->bhkv", k.float(), v.float())
    y = torch.einsum("bhk,bhkv->bhv", r.float(),
                     S + u.float()[None, :, :, None] * kv)
    S = S * w.float()[..., None] + kv
    return y, S


def _ddecay(p, xw):
    """Data-dependent decay (the RWKV6 signature): w = exp(-exp(w0 + lora))."""
    lora = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    logw = p["w0"].float() + lora.float()
    return torch.exp(-torch.exp(logw))


def _mix(x, xx, mu):
    return x + (xx - x) * mu


def time_mix(p, x, cfg, *, shift_state=None, wkv_state=None,
             decode: bool = False, train: bool = False):
    """Time-mix.  Returns (out, last input, final WKV state); the state is
    None where B8 ran (the kernel starts from zero and keeps no final
    state).  On the card B8 reads r, k, v and the f32 decay as the views
    the projections give and returns y (B, S, H, V) f32 in memory order,
    which the group norm reads as it is.  ``train`` runs ``wkv6_scan``
    instead, on any device.  ``decode`` runs one token (S = 1) from
    ``wkv_state`` through ``wkv6_step``, on any device.  A whole sequence
    from a ``wkv_state`` runs only on the CPU: B8 has no initial state,
    and no reference path asks for one (its decode steps one token)."""
    kernel = x.device.type != "cpu" and not train and not decode
    if wkv_state is not None and kernel:
        raise NotImplementedError(
            "time_mix over a sequence from a WKV state runs only on the "
            "CPU: B8 starts from zero; decode steps one token "
            "(decode=True)")
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    xx = token_shift(x, shift_state)
    r = _mix(x, xx, p["mu_r"]) @ p["w_r"]
    k = _mix(x, xx, p["mu_k"]) @ p["w_k"]
    v = _mix(x, xx, p["mu_v"]) @ p["w_v"]
    g = F.silu(_mix(x, xx, p["mu_g"]) @ p["w_g"])
    w = _ddecay(p, _mix(x, xx, p["mu_w"]))                     # (B,S,D)

    r, k, v, w = (constrain(split_heads(t, (b, s, h, hd)), "b.h.")
                  for t in (r, k, v, w))
    if decode:
        y, wkv_state = wkv6_step(wkv_state, r[:, 0], k[:, 0], v[:, 0],
                                 w[:, 0], p["u"])
        y = y[:, None]
    elif kernel:
        t = lambda a: a.transpose(1, 2)                      # (B,H,S,·) views
        # on a mesh each rank runs its own batch rows and heads
        y = on_rank_shards(
            lambda r, k, v, w, u: _wkv.wkv6_chunked(
                t(r), t(k), t(v), t(w), u,
                out_dtype=torch.float32).transpose(1, 2),
            (r, k, v, w, p["u"]), ("b.h.",) * 4 + ("h.",), "b.h.")
    else:
        y, wkv_state = fused(wkv6_scan, r, k, v, w, p["u"], wkv_state)
    # per-head group norm
    yf = y.float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = yf.var(dim=-1, unbiased=False, keepdim=True)
    y = ((yf - mean) * torch.rsqrt(var + 64e-5)).to(x.dtype)
    y = merge_heads(y, (b, s, d)) * g
    return y @ p["w_o"], x[:, -1:], wkv_state


def channel_mix(p, x, cfg, *, shift_state=None):
    xx = token_shift(x, shift_state)
    xk = _mix(x, xx, p["cmu_k"])
    xr = _mix(x, xx, p["cmu_r"])
    kk = torch.square(torch.relu(xk @ p["cw_k"]))
    return torch.sigmoid(xr @ p["cw_r"]) * (kk @ p["cw_v"]), x[:, -1:]


def init_rwkv6(normal, cfg, dtype, lead=()):
    """One RWKV-6 block's parameters with ``lead`` stacking dims in front:
    the reference's shapes, scales and constants.  ``normal(shape, scale,
    dtype)`` draws the random weights on the target device."""
    d, f = cfg.d_model, cfg.d_ff
    h, hd = cfg.n_heads, cfg.head_dim
    lora_r = max(16, d // 64)
    sc = d ** -0.5
    w_r = normal((*lead, d, d), sc, dtype)
    dev = w_r.device
    full = lambda shape, val, dt: torch.full((*lead, *shape), val, dtype=dt,
                                             device=dev)
    return {
        **{f"mu_{n}": full((d,), 0.5, dtype) for n in "rkvgw"},
        "w_r": w_r,
        "w_k": normal((*lead, d, d), sc, dtype),
        "w_v": normal((*lead, d, d), sc, dtype),
        "w_g": normal((*lead, d, d), sc, dtype),
        "w_o": normal((*lead, d, d), sc, dtype),
        "w_lora_a": normal((*lead, d, lora_r), sc, dtype),
        "w_lora_b": normal((*lead, lora_r, d), lora_r ** -0.5, dtype),
        "w0": full((d,), -2.0, torch.float32),
        "u": normal((*lead, h, hd), 0.5, torch.float32),
        "cmu_k": full((d,), 0.5, dtype),
        "cmu_r": full((d,), 0.5, dtype),
        "cw_k": normal((*lead, d, f), sc, dtype),
        "cw_v": normal((*lead, f, d), f ** -0.5, dtype),
        "cw_r": normal((*lead, d, d), sc, dtype),
    }
