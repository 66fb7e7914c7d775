"""Mamba2 (SSD) block: the chunked SSD scan, the causal depthwise
convolution and the block around them (prefill), and the one-token
recurrent step (decode).

``ssd_chunked`` is the reference's XLA scan line for line: within a chunk
the output is a masked ``(C_i·B_j)·decay`` product, across chunks a
``(heads, head_dim, d_state)`` state carries the chunk's total decay.  On
CUDA tensors ``mamba2_block`` launches the hand-written kernel B7
(``kernels.mamba_scan``) instead — in bf16 the same chunked form on the
tensor cores (chunks of 64), in f32 the recurrence step by step, each
equal to ``ssd_chunked`` up to float order — on views of the heads
(``(Bt, H, S, P)`` transposes of the conv output's columns, dt and the B
and C columns as they are) and takes y back as a view of ``(Bt, S, H,
P)`` memory, so no copy is made on either side; on the CPU, and on any
device when the caller asks for the training form (``train=True``: B7 has
no backward), the block runs ``ssd_chunked`` under autograd.
The one-token decode step (``ssd_decode_step``, ``mamba2_decode``) is
the reference's plain ``jnp`` step in PyTorch on every device: an
``(H, P, N)`` state update and a ``K − 1``-row convolution state per
token need no kernel of their own.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import mamba_scan as _ssd
from repro_torch.launch.hlo_analysis import fused
from repro_torch.models.layers import rms_norm
from repro_torch.models.shard_ctx import (constrain, on_rank_shards,
                                         split_heads)


def ssd_chunked(x, dt, A_log, B, C, D_skip, *, chunk: int, h0=None):
    """Chunked SSD scan.

    x: (Bt, S, H, P)   values (P = head_dim)
    dt: (Bt, S, H)     softplus'd step sizes
    A_log: (H,)        log of -A (per-head decay rate)
    B, C: (Bt, S, N)   input/output projections (single group)
    D_skip: (H,)       skip connection
    h0: optional (Bt, H, P, N) initial state
    Returns y (Bt, S, H, P) in x's dtype and the final state (Bt, H, P, N).
    On a mesh each rank scans its own batch rows and heads over the whole
    sequence.
    """
    return on_rank_shards(
        partial(_ssd_chunked, chunk=chunk), (x, dt, A_log, B, C, D_skip, h0),
        ("b.h.", "b.h", "h", "b..", "b..", "h",
         None if h0 is None else "bh.."), ("b.h.", "bh.."))


def _ssd_chunked(x, dt, A_log, B, C, D_skip, h0, *, chunk: int):
    bt, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    while s % q:
        q -= 1
    nc = s // q

    a = -torch.exp(A_log.float())                              # (H,)
    dtf = dt.float()
    la = dtf * a                                               # (Bt,S,H) log-decay
    xf = x.float() * dtf[..., None]                            # dt-weighted input
    Bf = B.float()
    Cf = C.float()

    lac = la.reshape(bt, nc, q, h).permute(1, 0, 3, 2)          # (nc,Bt,H,Q)
    xc = xf.reshape(bt, nc, q, h, p).permute(1, 0, 3, 2, 4)     # (nc,Bt,H,Q,P)
    Bc = Bf.reshape(bt, nc, q, n).permute(1, 0, 2, 3)           # (nc,Bt,Q,N)
    Cc = Cf.reshape(bt, nc, q, n).permute(1, 0, 2, 3)

    hprev = (torch.zeros((bt, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0)
    idx = torch.arange(q, device=x.device)
    tri = idx[:, None] >= idx[None, :]                          # (Q,Q) causal

    ys = []
    for lak, xk, Bk, Ck in zip(lac, xc, Bc, Cc):
        cum = torch.cumsum(lak, dim=-1)                         # (Bt,H,Q)
        # intra-chunk: decay(i<-j) = exp(cum_i - cum_j) for j<=i
        dmat = torch.exp(torch.where(tri, cum[..., :, None] - cum[..., None, :],
                                     -torch.inf))               # (Bt,H,Q,Q)
        cb = torch.einsum("bin,bjn->bij", Ck, Bk)               # (Bt,Q,Q)
        y_intra = torch.einsum("bij,bhij,bhjp->bhip", cb, dmat, xk)
        # inter-chunk: y_i += exp(cum_i) C_i . h_prev
        dec_in = torch.exp(cum)                                 # (Bt,H,Q)
        y_inter = torch.einsum("bin,bhpn,bhi->bhip", Ck, hprev, dec_in)
        # state update: h = exp(cum_Q) h + sum_j exp(cum_Q-cum_j) B_j x_j
        tot = cum[..., -1:]                                     # (Bt,H,1)
        dec_out = torch.exp(tot - cum)                          # (Bt,H,Q)
        hprev = hprev * torch.exp(tot)[..., None] \
            + torch.einsum("bhj,bjn,bhjp->bhpn", dec_out, Bk, xk)
        ys.append(y_intra + y_inter)

    yc = torch.stack(ys)                                        # (nc,Bt,H,Q,P)
    y = yc.permute(1, 0, 3, 2, 4).reshape(bt, s, h, p)
    y = y + x.float() * D_skip.float()[None, None, :, None]
    return y.to(x.dtype), hprev


def ssd_decode_step(h, x, dt, A_log, B, C, D_skip):
    """One recurrent SSD step.

    h: (Bt, H, P, N) f32; x: (Bt, H, P); dt: (Bt, H); B, C: (Bt, N).
    Returns y (Bt, H, P) in x's dtype and the new state (f32)."""
    a = -torch.exp(A_log.float())
    alpha = torch.exp(dt.float() * a)                           # (Bt,H)
    xin = x.float() * dt.float()[..., None]
    hnew = h * alpha[..., None, None] \
        + torch.einsum("bhp,bn->bhpn", xin, B.float())
    y = torch.einsum("bhpn,bn->bhp", hnew, C.float())
    y = y + x.float() * D_skip.float()[None, :, None]
    return y.to(x.dtype), hnew


def causal_conv1d(x, w, b, *, state=None):
    """Depthwise causal conv. x: (Bt, S, Ch); w: (K, Ch); b: (Ch,).

    state: optional (Bt, K-1, Ch) left context (decode).  Returns conv out
    and the new state (last K-1 inputs)."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)                           # (Bt,S+K-1,Ch)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else state
    return out + b, new_state


def _softplus(x):
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba2_split(p, x, cfg):
    """Apply in_proj and split into (z, xs, B, C, dt)."""
    s_cfg = cfg.ssm
    d_in = s_cfg.expand * cfg.d_model
    n = s_cfg.d_state
    nh = d_in // s_cfg.head_dim
    proj = x @ p["w_in"]                                        # (...,2di+2n+nh)
    z, xs, Bv, Cv, dt = torch.split(proj, [d_in, d_in, n, n, nh], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"].float())
    return z, xs, Bv, Cv, dt, d_in, n, nh


def mamba2_block(p, x, cfg, *, train: bool = False):
    """Full Mamba2 block.  x: (Bt, S, D) -> (Bt, S, D).  Off the CPU the
    SSD scan is B7, unless ``train`` asks for the differentiable
    ``ssd_chunked``."""
    s_cfg = cfg.ssm
    bt, s, _ = x.shape
    z, xs, Bv, Cv, dt, d_in, n, nh = mamba2_split(p, x, cfg)
    conv_in = torch.cat([xs, Bv, Cv], dim=-1)
    conv_out, _ = causal_conv1d(conv_in, p["conv_w"], p["conv_b"])
    conv_out = F.silu(conv_out)
    xs, Bv, Cv = torch.split(conv_out, [d_in, n, n], dim=-1)
    xh = constrain(split_heads(xs, (bt, s, nh, s_cfg.head_dim)), "b.h.")
    dt = constrain(dt, "b.h")
    if x.device.type != "cpu" and not train:
        # views in, a view out: B7 reads the strides of the conv output's
        # columns and writes y in (Bt, S, H, P) memory; on a mesh each
        # rank scans its own batch rows and heads
        def scan(xh, dt, a_log, b, c, d):
            return _ssd.mamba_ssd_scan(
                xh.transpose(1, 2), dt.transpose(1, 2), a_log, b, c, d,
                chunk=s_cfg.chunk).transpose(1, 2)
        y = on_rank_shards(scan, (xh, dt, p["A_log"], Bv, Cv, p["D"]),
                           ("b.h.", "b.h", "h", "b..", "b..", "h"), "b.h.")
    else:
        y, _ = fused(ssd_chunked, xh, dt, p["A_log"], Bv, Cv, p["D"],
                     chunk=s_cfg.chunk)
    y = y.reshape(bt, s, d_in) * F.silu(z)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    return y @ p["w_out"]


def mamba2_decode(p, x, cfg, state):
    """One decode step.  x: (Bt, 1, D); state: {"h": (Bt, H, P, N) f32,
    "conv": (Bt, K-1, d_in + 2N)}.  Returns (Bt, 1, D) and the new state
    (fresh tensors; the caller's state is not touched)."""
    s_cfg = cfg.ssm
    bt = x.shape[0]
    z, xs, Bv, Cv, dt, d_in, n, nh = mamba2_split(p, x, cfg)
    conv_in = torch.cat([xs, Bv, Cv], dim=-1)
    conv_out, conv_state = causal_conv1d(conv_in, p["conv_w"], p["conv_b"],
                                         state=state["conv"])
    conv_out = F.silu(conv_out)
    xs, Bv, Cv = torch.split(conv_out, [d_in, n, n], dim=-1)
    xh = xs[:, 0].reshape(bt, nh, s_cfg.head_dim)
    y, h = ssd_decode_step(state["h"], xh, dt[:, 0], p["A_log"],
                           Bv[:, 0], Cv[:, 0], p["D"])
    y = y.reshape(bt, 1, d_in) * F.silu(z)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    return y @ p["w_out"], {"h": h, "conv": conv_state}


def init_mamba2(normal, cfg, dtype, lead=()):
    """One Mamba2 block's parameters with ``lead`` stacking dims in front:
    the reference's shapes, scales and constants.  ``normal(shape, scale,
    dtype)`` draws the random weights on the target device."""
    s_cfg = cfg.ssm
    d = cfg.d_model
    d_in = s_cfg.expand * d
    n = s_cfg.d_state
    nh = d_in // s_cfg.head_dim
    conv_ch = d_in + 2 * n
    scale = d ** -0.5
    w_in = normal((*lead, d, 2 * d_in + 2 * n + nh), scale, dtype)
    dev = w_in.device

    def const(values, dt=torch.float32):
        t = torch.as_tensor(np.asarray(values, np.float32), device=dev)
        return t.to(dt).expand(*lead, *t.shape).clone()
    return {
        "w_in": w_in,
        "conv_w": normal((*lead, s_cfg.d_conv, conv_ch),
                         s_cfg.d_conv ** -0.5, dtype),
        "conv_b": const(np.zeros(conv_ch), dtype),
        "dt_bias": const(np.log(np.expm1(np.linspace(1e-3, 0.1, nh)))),
        "A_log": const(np.log(np.linspace(1.0, 16.0, nh))),
        "D": const(np.ones(nh)),
        "out_norm": const(np.zeros(d_in)),
        "w_out": normal((*lead, d_in, d), d_in ** -0.5, dtype),
    }
