"""The RWKV-6 WKV recurrence from a zero state (B8).

``wkv6_chunked`` runs a kernel hand-written in CUDA for Hopper
(``csrc/wkv6.cu``) in place of the reference's Pallas TPU kernel
(``kernels/wkv6.py`` ``wkv6_chunked``): per (b, h) a ``(K, V)`` state
``S`` from zero, and at each step ``y = r·(S + u·kᵀv)``, then
``S = S·w + kᵀv``, in f32.  The TPU kernel's chunk grid is a loop inside
one block per (b, h) here, so ``chunk`` does not change the math (it is
kept for the reference's signature).

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor — and only then — it runs the plain version, the per-step oracle
``ref.wkv6_ref`` in the kernel's ``(B, H, S, ·)`` layout.  ``launch_count``
counts kernel launches, ``plain_count`` plain runs, per input dtype
(``f32``, ``bf16``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _common as _c
from repro_torch.kernels.ref import wkv6_ref

KERNEL_VARIANTS = {"wkv6_chunked": ("f32", "bf16")}
_COUNTS = _c.Counts(KERNEL_VARIANTS)
launch_count = _COUNTS.launch_count
plain_count = _COUNTS.plain_count
reset_counts = _COUNTS.reset

KEY_DIMS = (32, 64, 128)
VALUE_DIMS = (32, 64)


def wkv6_plain(r, k, v, w, u):
    """Plain form of ``wkv6_chunked``: the per-step oracle, transposed
    around to the kernel's ``(B, H, S, ·)`` layout."""
    tr = lambda t: t.transpose(1, 2)
    y, _ = wkv6_ref(tr(r), tr(k), tr(v), tr(w), u)
    return tr(y).contiguous()


def _lib():
    from repro_torch.kernels._build import library
    lib = library("wkv6")
    if not getattr(lib, "_repro_bound", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_wkv6.argtypes = [vp] * 6 + [i32] * 6 + [vp]
        lib.repro_wkv6.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def wkv6_chunked(r, k, v, w, u, *, chunk: int = 128):
    """r, k, w: (B, H, S, K); v: (B, H, S, V); u: (H, K).  Returns y
    (B, H, S, V) in r's dtype (B8), from a zero state.  r, k, v and w
    share one dtype, f32 or bf16; u is read as f32."""
    name = "wkv6_chunked"
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape \
            or v.dim() != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"{name}: r, k, w must be (B, H, S, K) and v "
                         f"(B, H, S, V); got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w.shape)}")
    b, h, s, kd = r.shape
    vd = v.shape[-1]
    if tuple(u.shape) != (h, kd):
        raise ValueError(f"{name}: u must be ({h}, {kd}), got "
                         f"{tuple(u.shape)}")
    if r.dtype not in _c.FLOATS or any(t.dtype != r.dtype for t in (k, v, w)):
        raise ValueError(f"{name}: r, k, v, w must share one dtype, float32 "
                         f"or bfloat16; got {r.dtype}, {k.dtype}, {v.dtype}, "
                         f"{w.dtype}")
    variant = _c.variant_of(r)
    if r.device.type == "cpu":
        _COUNTS.plain(name, variant)
        return wkv6_plain(r, k, v, w, u)
    if kd not in KEY_DIMS or vd not in VALUE_DIMS:
        raise ValueError(f"{name}: K {kd} must be one of {KEY_DIMS} and V "
                         f"{vd} one of {VALUE_DIMS}")
    _c.check_launchable(name, r, k, v, w, u)
    uf = u.float().contiguous()
    y = torch.empty_like(v)
    err = _lib().repro_wkv6(_c.ptr(r), _c.ptr(k), _c.ptr(v), _c.ptr(w),
                            _c.ptr(uf), _c.ptr(y), b, h, s, kd, vd,
                            int(r.dtype == torch.bfloat16), _c.stream_of(r))
    _c.raise_on(err, name)
    _COUNTS.launch(name, variant)
    return y
