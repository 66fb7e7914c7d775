"""Causal + sliding-window GQA attention with an online softmax (B4).

``flash_attention`` runs a kernel hand-written in CUDA for Hopper
(``csrc/flash_attention.cu``) in place of the reference's Pallas TPU
kernel (``kernels/flash_attention.py`` ``flash_attention``): q
``(B, H, Sq, hd)`` against k, v ``(B, KV, Sk, hd)`` with the KV head
``h // n_rep``, query ``i`` at position ``q_offset + i`` and keys from 0,
masked to ``j <= q_offset + i`` (and ``q_offset + i − j < window`` when
``window > 0``) when ``causal``.  ``q_offset = 0`` is the prefill (the
TPU kernel's only form); ``q_offset = pos`` over a whole KV cache is a
chunk of queries behind it (``models.transformer.decode_attention_dyn``),
held against the reference's einsum form there, as the TPU kernel has no
offset.  ``q_offset`` is a host int or a 0-d int32 tensor on q's device,
which the kernel reads on the card (the position of a decode step never
reaches the host; the grid depends on the shapes only).  k and v are read
through their strides (the last dimension contiguous): the ``(B, S, KV,
hd)`` layer cache as its ``transpose(1, 2)`` view, with no copy.  Scores,
softmax and the product with v in f32, the output in q's dtype.  It skips
key tiles wholly above the diagonal or before the window, and takes any
``Sq``/``Sk`` (the TPU kernel asks for multiples of its block): over a
whole cache, a chunk at ``pos`` loads the key tiles up to ``pos + Sq``
only.

Two routes, by dtype: bf16 on the tensor cores (``wgmma`` on bf16 q and
k, the scores scaled in f32 after the product, and P·V with P split into
``bf16(P) + bf16(P − bf16(P))``), f32 on the CUDA cores.  Neither falls
back to the other.

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor — and only then — it runs the plain version, the naive-softmax
oracle ``ref.flash_attention_ref``.  ``launch_count`` counts kernel
launches, ``plain_count`` plain runs, per dtype (``f32``, ``bf16``).

Under a cost count (``launch.hlo_analysis``) a launch adds the kernel's
own work, ``flash_attention_work``; meta tensors then take the card's
checks and return an empty output of the kernel's shape (``meta_count``),
and outside a count they are refused like any other device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _common as _c
from repro_torch.kernels.ref import flash_attention_ref

KERNEL_VARIANTS = {"flash_attention": ("f32", "bf16")}
_COUNTS = _c.Counts(KERNEL_VARIANTS)
launch_count = _COUNTS.launch_count
plain_count = _COUNTS.plain_count
meta_count = _COUNTS.meta_count
reset_counts = _COUNTS.reset

HEAD_DIMS = (32, 64, 80, 96, 128, 256)


# the plain form of ``flash_attention``: the naive-softmax oracle
flash_attention_plain = flash_attention_ref


def _bands(sq: int, sk: int, causal: bool, window: int, q_offset: int):
    """Each query's first and last kept key: query ``i`` at ``q_offset +
    i`` attends to keys ``j < sk`` with ``j <= q_offset + i`` (and
    ``q_offset + i - j < window`` when ``window > 0``) when ``causal``."""
    p = torch.arange(q_offset, q_offset + sq, dtype=torch.int64)
    if not causal:
        return torch.zeros_like(p), torch.full_like(p, sk - 1)
    hi = p.clamp(max=sk - 1)
    lo = (p - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(p)
    return lo, hi


def band_pairs(sq: int, sk: int, *, causal: bool = True, window: int = 0,
               q_offset: int = 0) -> int:
    """(query, key) pairs the mask keeps (``_bands``)."""
    lo, hi = _bands(sq, sk, causal, window, q_offset)
    return int((hi - lo + 1).clamp(min=0).sum())


def _offset_value(q_offset, sq: int, sk: int) -> int:
    """``q_offset`` as a host int: a tensor one read to the host, a meta
    one (no value) the cache's last chunk, ``sk - sq`` — the step its
    shapes describe, as B5's count takes the cache's last position."""
    if not isinstance(q_offset, torch.Tensor):
        return int(q_offset)
    return max(sk - sq, 0) if q_offset.device.type == "meta" \
        else int(q_offset)


def flash_attention_work(q, k, v, *, causal: bool = True, window: int = 0,
                         q_offset=0):
    """(FLOPs, bytes) of one B4 call, the bound's formula: q read and the
    output written once, each K and V row some query keeps read once;
    4·hd operations a kept (query head, key) pair (QKᵀ and PV), the masked
    ones skipped.  A tensor ``q_offset`` is read (``_offset_value``)."""
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    off = _offset_value(q_offset, sq, sk)
    pairs = band_pairs(sq, sk, causal=causal, window=int(window),
                       q_offset=off)
    lo, hi = _bands(sq, sk, causal, int(window), off)
    rows = max(int(hi.max()) - int(lo.min()) + 1, 0)
    nbytes = (2 * q.numel() + 2 * b * kvh * rows * hd) * q.element_size()
    return 4 * hd * b * h * pairs, nbytes


def _lib():
    from repro_torch.kernels._build import library
    lib = library("flash_attention")
    if not getattr(lib, "_repro_bound", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_flash_attention.argtypes = [vp] * 4 + [i32] * 9 + [
            vp, vp, ctypes.c_float, i32, vp]
        lib.repro_flash_attention.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def readable(t) -> bool:
    """Whether B4 reads ``t`` (a k or v of (B, KV, Sk, hd)) as it lies: the
    last dimension contiguous and, for bf16 (TMA), a 16-byte-aligned base
    and outer strides of whole 16 bytes.  A caller copies a view that fails
    this; the wrapper refuses it."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        return False
    return t.dtype != torch.bfloat16 or _c.tma_readable(t)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset=0):
    """q: (B, H, Sq, hd) contiguous; k, v: (B, KV, Sk, hd) with H a
    multiple of KV, read through their strides (the last dimension
    contiguous; bf16 also 16-byte-aligned, ``readable``), one dtype (f32
    or bf16); ``q_offset``: the position of query 0, a host int >= 0 or a
    0-d int32 tensor on q's device, which the kernel reads on the card
    (the plain version gives both the same bits).  Returns (B, H, Sq, hd)
    contiguous in q's dtype (B4)."""
    name = "flash_attention"
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: q must be (B, H, Sq, hd) and k, v "
                         f"(B, KV, Sk, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if kvh < 1 or h % kvh:
        raise ValueError(f"{name}: {h} query heads over {kvh} KV heads")
    if q.dtype not in _c.FLOATS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must share one dtype, float32 or "
                         f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    q_offset = _c.position(name, "q_offset", q_offset, q.device)
    window = int(window)
    variant = _c.variant_of(q)
    if q.device.type == "cpu":
        _COUNTS.plain(name, variant)
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} is not one of {HEAD_DIMS}")
    _c.check_launchable(name, q, k, v, contiguous=False)
    if not q.is_contiguous():
        raise ValueError(f"{name}: the kernel reads a contiguous q; got "
                         f"strides {q.stride()} for shape {tuple(q.shape)}")
    for label, t in (("k", k), ("v", v)):
        if not readable(t):
            raise ValueError(
                f"{name}: the kernel reads {label} through its strides with "
                "the last dimension contiguous (bf16: by TMA, from a "
                "16-byte-aligned base with strides of whole 16 bytes); got "
                f"strides {t.stride()} for shape {tuple(t.shape)}")
    work = lambda: flash_attention_work(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset)
    if q.device.type == "meta":
        return _c.meta_launch(_COUNTS, name, variant, torch.empty_like(q),
                              work)
    if q.dtype == torch.bfloat16 and q.data_ptr() % 16:
        raise ValueError(f"{name}: the bf16 kernel loads q by TMA from a "
                         "16-byte-aligned tensor")
    host, dev = (q_offset, None) if isinstance(q_offset, int) else \
        (0, _c.ptr(q_offset))
    strides = (ctypes.c_int64 * 6)(*_c.strides_of(k, (0, 1, 2)),
                                   *_c.strides_of(v, (0, 1, 2)))
    out = torch.empty_like(q)
    err = _lib().repro_flash_attention(
        _c.ptr(q), _c.ptr(k), _c.ptr(v), _c.ptr(out), b, h, kvh, sq, sk, hd,
        int(bool(causal)), window, host, dev, strides, hd ** -0.5,
        int(q.dtype == torch.bfloat16), _c.stream_of(q))
    _c.raise_on(err, name)
    _COUNTS.launch(name, variant)
    _c.add_work(name, work)
    return out
