"""The Mamba2 SSD scan from a zero state (B7).

``mamba_ssd_scan`` runs a kernel hand-written in CUDA for Hopper
(``csrc/mamba_scan.cu``) in place of the reference's Pallas TPU kernel
(``kernels/mamba_scan.py`` ``mamba_ssd_scan``): per (b, h) a ``(P, N)``
state from zero, ``h = exp(dt·a)·h + (dt·x) ⊗ B`` and ``y = h·C + D·x``
with ``a = −exp(A_log)``, in f32.  It has two routes, chosen by dtype,
and neither falls back to the other:

* bf16 runs the chunked SSD decomposition on the tensor cores (``wgmma``)
  over chunks of 64 steps, with the f32 factors (decays, dt, the state)
  folded onto one side of each product and split into two bf16 parts;
* f32 runs the recurrence step by step on the CUDA cores.

Either way ``chunk`` changes only the float order of the chunked forms
(the kernel's chunk is 64 whatever it says); it is kept for the
reference's signature, and any ``S`` is taken.  One call launches one
CUDA kernel.

The kernel reads x, dt, B and C through their strides and writes y in
``(Bt, S, H, P)`` memory order, returned as the ``(Bt, H, S, P)`` view, so
``models.mamba2.mamba2_block`` hands over its views of the conv output
and gets y back without a copy either way.  What a load needs is checked,
never repaired by a copy: the last dimension of x, B and C contiguous,
and for the bf16 route (TMA) their bases and outer strides 16-byte
aligned.

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor — and only then — it runs the plain version, the per-step oracle
``ref.ssd_scan_ref`` in the kernel's ``(Bt, H, S, P)`` layout.
``launch_count`` counts kernel launches, ``plain_count`` plain runs, per
dtype of x (``f32``, ``bf16``).  Under a cost count a launch adds
``mamba_ssd_work``, and meta tensors take the card's checks and the
meta route (``_common.meta_launch``, ``meta_count``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _common as _c
from repro_torch.kernels.ref import ssd_scan_ref

KERNEL_VARIANTS = {"mamba_ssd_scan": ("f32", "bf16")}
_COUNTS = _c.Counts(KERNEL_VARIANTS)
launch_count = _COUNTS.launch_count
plain_count = _COUNTS.plain_count
meta_count = _COUNTS.meta_count
reset_counts = _COUNTS.reset

STATE_DIMS = (8, 16, 32, 64, 128)


def mamba_ssd_plain(x, dt, A_log, B, C, D_skip):
    """Plain form of ``mamba_ssd_scan``: the per-step oracle, transposed
    around to the kernel's ``(Bt, H, S, P)`` layout."""
    y, _ = ssd_scan_ref(x.transpose(1, 2), dt.transpose(1, 2), A_log, B, C,
                        D_skip)
    return y.transpose(1, 2).contiguous()


def ssd_chunked_flops(bt, h, s, p, n, q=64):
    """The products of B7's bf16 form: per (b, h) and chunk of q steps,
    C·Bᵀ (q x q x N), the masked decay matrix's two bf16 parts times x (q x
    q x P), C times the state's two parts (q x N x P, from the second chunk
    on) and xᵀ times W's two parts (P x q x N), 2 operations a
    multiply-add; a ragged last chunk runs whole."""
    nc = -(-s // q)
    per_chunk = 2 * q * q * n + 2 * (2 * q * q * p) + 2 * (2 * p * q * n)
    return bt * h * (nc * per_chunk + (nc - 1) * 2 * (2 * q * n * p))


def mamba_ssd_work(x, dt, A_log, B, C, D_skip):
    """(FLOPs, bytes) of one B7 call, the bound's formula: x, B, C read
    once, y written once, dt, A_log and D read as f32; the bf16 form's
    chunked products (``ssd_chunked_flops``, splits included), the f32
    form's step recurrence 5·P·N operations a (b, h, step)."""
    bt, h, s, p = x.shape
    n = B.shape[-1]
    nbytes = (2 * x.numel() + B.numel() + C.numel()) * x.element_size() \
        + 4 * (dt.numel() + 2 * h)
    if x.dtype == torch.bfloat16:
        return ssd_chunked_flops(bt, h, s, p, n), nbytes
    return 5 * p * n * s * bt * h, nbytes


def _lib():
    from repro_torch.kernels._build import library
    lib = library("mamba_scan")
    if not getattr(lib, "_repro_bound", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_mamba_ssd_scan.argtypes = [vp] * 8 + [i32] * 6 + [vp]
        lib.repro_mamba_ssd_scan.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def _check_loads(name, x, B, C, bf16: bool) -> None:
    """What the kernel's loads need of x, B and C: the last dimension
    contiguous; for the bf16 route (TMA) a 16-byte-aligned base and outer
    strides of whole 16-byte units.  Anything else is refused."""
    for label, t in (("x", x), ("B", B), ("C", C)):
        _c.check_last_contiguous(name, label, t)
        if bf16:
            _c.check_tma(name, label, t)


def mamba_ssd_scan(x, dt, A_log, B, C, D_skip, *, chunk: int = 128):
    """x: (Bt, H, S, P); dt: (Bt, H, S); A_log, D_skip: (H,); B, C:
    (Bt, S, N) (one group), any of them strided views.  Returns y
    (Bt, H, S, P) in x's dtype (B7), from a zero state; on the card the
    ``(Bt, H, S, P)`` view of ``(Bt, S, H, P)`` memory.  x, B and C share
    one dtype, f32 or bf16; dt, A_log and D_skip are read as f32."""
    name = "mamba_ssd_scan"
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (Bt, H, S, P), got "
                         f"{tuple(x.shape)}")
    bt, h, s, p = x.shape
    n = B.shape[-1]
    if tuple(dt.shape) != (bt, h, s) or tuple(A_log.shape) != (h,) \
            or tuple(D_skip.shape) != (h,) or tuple(B.shape) != (bt, s, n) \
            or C.shape != B.shape:
        raise ValueError(f"{name}: for x {tuple(x.shape)} want dt "
                         f"({bt}, {h}, {s}), A_log and D ({h},), B and C "
                         f"({bt}, {s}, N); got {tuple(dt.shape)}, "
                         f"{tuple(A_log.shape)}, {tuple(D_skip.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    if x.dtype not in _c.FLOATS or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"{name}: x, B, C must share one dtype, float32 or "
                         f"bfloat16; got {x.dtype}, {B.dtype}, {C.dtype}")
    variant = _c.variant_of(x)
    if x.device.type == "cpu":
        _COUNTS.plain(name, variant)
        return mamba_ssd_plain(x, dt, A_log, B, C, D_skip)
    if n not in STATE_DIMS:
        raise ValueError(f"{name}: N {n} must be one of {STATE_DIMS}")
    _c.check_launchable(name, x, dt, A_log, B, C, D_skip, contiguous=False)
    bf16 = x.dtype == torch.bfloat16
    _check_loads(name, x, B, C, bf16)
    work = lambda: mamba_ssd_work(x, dt, A_log, B, C, D_skip)
    if x.device.type == "meta":
        y = torch.empty((bt, s, h, p), dtype=x.dtype,
                        device=x.device).transpose(1, 2)
        return _c.meta_launch(_COUNTS, name, variant, y, work)
    dtf = dt.float()
    af, df = (t.float().contiguous() for t in (A_log, D_skip))
    y = torch.empty((bt, s, h, p), dtype=x.dtype,
                    device=x.device).transpose(1, 2)
    strides = (ctypes.c_int64 * 13)(
        *_c.strides_of(x, (0, 1, 2)), *_c.strides_of(dtf, (0, 1, 2)),
        *_c.strides_of(B, (0, 1)), *_c.strides_of(C, (0, 1)),
        *_c.strides_of(y, (0, 1, 2)))
    err = _lib().repro_mamba_ssd_scan(
        _c.ptr(x), _c.ptr(dtf), _c.ptr(af), _c.ptr(B), _c.ptr(C), _c.ptr(df),
        _c.ptr(y), ctypes.cast(strides, ctypes.c_void_p), bt, h, s, p, n,
        int(bf16), _c.stream_of(x))
    _c.raise_on(err, name)
    _COUNTS.launch(name, variant)
    _c.add_work(name, work)
    return y
