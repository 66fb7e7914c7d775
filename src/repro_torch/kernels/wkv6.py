"""The RWKV-6 WKV recurrence from a zero state (B8).

``wkv6_chunked`` runs a kernel hand-written in CUDA for Hopper
(``csrc/wkv6.cu``) in place of the reference's Pallas TPU kernel
(``kernels/wkv6.py`` ``wkv6_chunked``): per (b, h) a ``(K, V)`` state
``S`` from zero, and at each step ``y = r·(S + u·kᵀv)``, then
``S = S·w + kᵀv``, in f32.  It has two routes, chosen by dtype and key
width, and neither falls back to the other:

* bf16 r, k, v with K of 32 or 64 (the model's form) run a chunked form
  on the tensor cores (``wgmma``) over chunks of 64 steps in sub-chunks
  of 16, every decay a product of w, each f32 operand split into three
  bf16 parts;
* f32 r, k, v, and bf16 with K = 128, run the recurrence step by step on
  the CUDA cores.

``chunk`` changes nothing (the kernel's chunk is 64 whatever it says);
it is kept for the reference's signature, and any ``S`` is taken.  One
call launches one CUDA kernel.

The kernel reads r, k, v and w through their strides and writes y in
``(B, S, H, V)`` memory order, returned as the ``(B, H, S, V)`` view, so
``models.rwkv6.time_mix`` hands over its ``(B, S, H, ·)`` projections as
``(B, H, S, ·)`` views and gets y back in the layout its group norm reads,
without a copy either way.  On the card w must be f32 (the model's decay
is); what a load needs is checked, never repaired by a copy: the last
dimension of every input contiguous, and for the tensor-core route (TMA)
16-byte-aligned bases and outer strides.

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor — and only then — it runs the plain version, the per-step oracle
``ref.wkv6_ref`` in the kernel's ``(B, H, S, ·)`` layout.  ``launch_count``
counts kernel launches, ``plain_count`` plain runs, per dtype of r
(``f32``, ``bf16``).  Under a cost count a launch adds ``wkv6_work``, and
meta tensors take the card's checks and the meta route
(``_common.meta_launch``, ``meta_count``).
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
meta_count = _COUNTS.meta_count
reset_counts = _COUNTS.reset

KEY_DIMS = (32, 64, 128)
VALUE_DIMS = (32, 64)
TENSOR_CORE_KEY_DIMS = (32, 64)


def wkv6_plain(r, k, v, w, u, *, out_dtype=None):
    """Plain form of ``wkv6_chunked``: the per-step oracle, transposed
    around to the kernel's ``(B, H, S, ·)`` layout."""
    tr = lambda t: t.transpose(1, 2)
    y, _ = wkv6_ref(tr(r), tr(k), tr(v), tr(w), u, out_dtype=out_dtype)
    return tr(y).contiguous()


def wkv_chunked_flops(b, h, s, kd, vd, q=64, sub=16, parts=3):
    """The products of B8's tensor-core form: per (b, h) and chunk of q
    steps, with K padded to 64 and each f32 operand in ``parts`` bf16
    parts (6 products of two split sides, 3 against an exact one): y_inter
    (q x K x V, from the second chunk on), the 3 off-diagonal block
    columns of A (q x K x 16 each), A·v (q x q x V) and the state update
    (K x q x V), 2 operations a multiply-add; a ragged last chunk runs
    whole."""
    kp, nc = 64, -(-s // q)
    two, one = parts * (parts + 1) // 2, parts
    per_chunk = (2 * (q // sub - 1) * two * q * kp * sub
                 + 2 * one * q * q * vd + 2 * one * kp * q * vd)
    return b * h * (nc * per_chunk + (nc - 1) * 2 * two * q * kp * vd)


def wkv6_work(r, k, v, w, u, *, out_dtype=None):
    """(FLOPs, bytes) of one B8 call, the bound's formula: r, k, v, w, u
    read once and y written once in ``out_dtype``; the tensor-core form's
    chunked products (``wkv_chunked_flops``), the step recurrence's 7·K·V
    operations a (b, h, step)."""
    b, h, s, kd = r.shape
    y_size = (out_dtype or r.dtype).itemsize
    nbytes = (2 * r.numel() + v.numel()) * r.element_size() \
        + w.numel() * w.element_size() + v.numel() * y_size + 4 * u.numel()
    if tensor_core_route(r, k):
        return wkv_chunked_flops(b, h, s, kd, v.shape[-1]), nbytes
    return 7 * kd * v.shape[-1] * s * b * h, nbytes


def _lib():
    from repro_torch.kernels._build import library
    lib = library("wkv6")
    if not getattr(lib, "_repro_bound", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_wkv6.argtypes = [vp] * 7 + [i32] * 7 + [vp]
        lib.repro_wkv6.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def tensor_core_route(r, k) -> bool:
    """Whether the kernel runs the chunked form on the tensor cores for
    these inputs (else the step recurrence)."""
    return r.dtype == torch.bfloat16 and k.shape[-1] in TENSOR_CORE_KEY_DIMS


def wkv6_chunked(r, k, v, w, u, *, chunk: int = 128, out_dtype=None):
    """r, k, w: (B, H, S, K); v: (B, H, S, V); u: (H, K); any of them
    strided views.  Returns y (B, H, S, V) in ``out_dtype`` (r's dtype
    when None: the reference's contract), from a zero state; on the card
    the ``(B, H, S, V)`` view of ``(B, S, H, V)`` memory.  r, k and v
    share one dtype, f32 or bf16; on the card w is f32; u is read as
    f32."""
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
    if r.dtype not in _c.FLOATS or any(t.dtype != r.dtype for t in (k, v)) \
            or w.dtype not in _c.FLOATS:
        raise ValueError(f"{name}: r, k, v must share one dtype, float32 "
                         f"or bfloat16, and w be one of those; got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}, {w.dtype}")
    out_dtype = out_dtype or r.dtype
    if out_dtype not in _c.FLOATS:
        raise ValueError(f"{name}: out_dtype must be float32 or bfloat16, "
                         f"got {out_dtype}")
    variant = _c.variant_of(r)
    if r.device.type == "cpu":
        _COUNTS.plain(name, variant)
        return wkv6_plain(r, k, v, w, u, out_dtype=out_dtype)
    _c.check_launchable(name, r, k, v, w, u, contiguous=False)
    if kd not in KEY_DIMS or vd not in VALUE_DIMS:
        raise ValueError(f"{name}: K {kd} must be one of {KEY_DIMS} and V "
                         f"{vd} one of {VALUE_DIMS}")
    if w.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel reads w as float32 (the "
                         f"model's decay); got {w.dtype}")
    tc = tensor_core_route(r, k)
    for label, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _c.check_last_contiguous(name, label, t)
        if tc:
            _c.check_tma(name, label, t)
    work = lambda: wkv6_work(r, k, v, w, u, out_dtype=out_dtype)
    y = torch.empty((b, s, h, vd), dtype=out_dtype,
                    device=r.device).transpose(1, 2)
    if r.device.type == "meta":
        return _c.meta_launch(_COUNTS, name, variant, y, work)
    uf = u.float().contiguous()
    strides = (ctypes.c_int64 * 15)(
        *(st for t in (r, k, v, w, y) for st in _c.strides_of(t, (0, 1, 2))))
    err = _lib().repro_wkv6(
        _c.ptr(r), _c.ptr(k), _c.ptr(v), _c.ptr(w), _c.ptr(uf), _c.ptr(y),
        ctypes.cast(strides, ctypes.c_void_p), b, h, s, kd, vd,
        int(r.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        _c.stream_of(r))
    _c.raise_on(err, name)
    _COUNTS.launch(name, variant)
    _c.add_work(name, work)
    return y
