"""RWKV-6 (Finch) block: time-mix with data-dependent decay and
channel-mix, over a whole sequence (prefill) or one token from a state
(decode).

``wkv6_scan`` is the reference's scan over time (the WKV recurrence) line
for line.  On CUDA tensors ``time_mix`` launches the hand-written kernel
B8 (``kernels.wkv6``) instead, on the ``(B, H, S, ·)`` views of its
``(B, S, H, ·)`` projections as they are (r, k, v in the model's dtype,
the decay w in f32) and with an f32 output, as the reference's scan
returns f32; the kernel writes y in ``(B, S, H, V)`` memory, so the
per-head group norm reads it without a copy, and nothing is cast or
transposed around B8.  On the CPU ``time_mix`` runs ``wkv6_scan``, from
a given state too, and so it does on any device when the caller asks for
the training form (``train=True``: B8 has no backward), under autograd;
on the card a given state raises (no reference path runs a whole
sequence from a state).  The one-token decode step (``wkv6_step``,
``time_mix(..., decode=True)``) is the reference's plain ``jnp`` step in
PyTorch on every device: one ``(H, K, V)`` state update per token needs
no kernel of its own.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import wkv6 as _wkv
from repro_torch.kernels.ref import wkv6_ref
from repro_torch.launch.hlo_analysis import fused
from repro_torch.models.shard_ctx import (constrain, merge_heads,
                                         on_rank_shards, split_heads)


def token_shift(x, shift_state=None):
    """Return previous-token tensor. x: (B, S, D)."""
    if shift_state is None:
        shift_state = torch.zeros_like(x[:, :1])
    return torch.cat([shift_state, x[:, :-1]], dim=1)


def wkv6_scan(r, k, v, w, u, state=None):
    """WKV6 recurrence.

    r,k,w: (B,S,H,K); v: (B,S,H,V); u: (H,K) bonus; state: (B,H,K,V).
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    Returns y (B,S,H,V) f32 and the final state: the per-step oracle
    ``ref.wkv6_ref`` from ``state``.  (The reference nests its scan in
    chunks only to bound its backward's memory, so its ``chunk`` argument
    has no counterpart; the steps are the same.)  On a mesh each rank
    scans its own batch rows and heads over the whole sequence."""
    return on_rank_shards(
        lambda r, k, v, w, u, state: wkv6_ref(r, k, v, w, u, state=state,
                                              out_dtype=torch.float32),
        (r, k, v, w, u, state),
        ("b.h.",) * 4 + ("h.", None if state is None else "bh.."),
        ("b.h.", "bh.."))


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
