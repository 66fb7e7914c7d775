"""RWKV-6 (Finch) block, prefill: time-mix with data-dependent decay and
channel-mix.

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
on the card a given state raises.  The one-token decode step (``wkv6_step``)
and a stateful WKV on the card wait for the decode slice (ROADMAP A14).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import wkv6 as _wkv
from repro_torch.kernels.ref import wkv6_ref


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
    has no counterpart; the steps are the same.)"""
    return wkv6_ref(r, k, v, w, u, state=state, out_dtype=torch.float32)


def _ddecay(p, xw):
    """Data-dependent decay (the RWKV6 signature): w = exp(-exp(w0 + lora))."""
    lora = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    logw = p["w0"].float() + lora.float()
    return torch.exp(-torch.exp(logw))


def _mix(x, xx, mu):
    return x + (xx - x) * mu


def time_mix(p, x, cfg, *, shift_state=None, wkv_state=None,
             train: bool = False):
    """Prefill time-mix.  Returns (out, last input, final WKV state); the
    state is None where B8 ran (the kernel starts from zero and keeps no
    final state).  On the card B8 reads r, k, v and the f32 decay as the
    views the projections give and returns y (B, S, H, V) f32 in memory
    order, which the group norm reads as it is.  ``train`` runs
    ``wkv6_scan`` instead, on any device.  A ``wkv_state`` to start from
    runs only on the CPU: B8 has no initial state, and that path is the
    decode slice's (ROADMAP A14)."""
    kernel = x.device.type != "cpu" and not train
    if wkv_state is not None and kernel:
        raise NotImplementedError(
            "time_mix from a WKV state runs only on the CPU: B8 starts from "
            "zero; stateful WKV on the card comes with the decode slice "
            "(ROADMAP A14)")
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    xx = token_shift(x, shift_state)
    r = _mix(x, xx, p["mu_r"]) @ p["w_r"]
    k = _mix(x, xx, p["mu_k"]) @ p["w_k"]
    v = _mix(x, xx, p["mu_v"]) @ p["w_v"]
    g = F.silu(_mix(x, xx, p["mu_g"]) @ p["w_g"])
    w = _ddecay(p, _mix(x, xx, p["mu_w"]))                     # (B,S,D)

    r, k, v, w = (t.reshape(b, s, h, hd) for t in (r, k, v, w))
    if kernel:
        t = lambda a: a.transpose(1, 2)                      # (B,H,S,·) views
        y = _wkv.wkv6_chunked(t(r), t(k), t(v), t(w), p["u"],
                              out_dtype=torch.float32).transpose(1, 2)
    else:
        y, wkv_state = wkv6_scan(r, k, v, w, p["u"], wkv_state)
    # per-head group norm
    yf = y.float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = yf.var(dim=-1, unbiased=False, keepdim=True)
    y = ((yf - mean) * torch.rsqrt(var + 64e-5)).to(x.dtype)
    y = y.reshape(b, s, d) * g
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
