"""The fused dual-batch server update over the flat store (paper §3.4).

The paper's global update applies the large-group gradient at factor 1 and
the small-group gradient at the model-update factor f:

    w' = w − lr · (g_L + f·g_S) / (1 + f)

Three kernels, hand-written in CUDA for Hopper (``csrc/dbl_merge.cu``),
replace the reference's Pallas TPU kernels:

  * ``dbl_apply_flat2d`` (B1) — the engine's per-step apply for a gradient
    that already carries the merge: ``v' = m·v + g; w' = w − lr·v'``;
  * ``dbl_merge_flat2d`` (B2) — the merge and apply in one sweep, for the
    per-step path that holds the two group gradients separately;
  * ``dbl_apply_worker_flat2d`` (B3) — one event of the traced
    parameter-server simulator: worker ``wid``'s momentum step and
    factor-scaled push, ``v'[wid] = m·v[wid] + g; w' = w + f·(−lr·v'[wid])``
    over the stacked ``(n_workers, rows, LANE)`` velocity.

B1 and B2 have four variants — plain, ``vel2`` (server momentum),
``master2`` (bf16 shadow + f32 master, written in the same pass) and both;
B3 has two, plain and master.  Each runs ONE launch over the whole
``(rows, LANE)`` buffer, updating every output in place over its input,
and returns the updated buffers in the reference's order, so call sites
read the same.

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor — and only then — it runs the plain PyTorch version, written as
separate eager ops in the kernel's float op order (the kernel is bit-equal
to it on the card).  ``launch_count`` counts kernel launches and nothing
else; ``plain_count`` counts runs of the plain versions.  ``KERNELS``
names the two four-variant kernels (B1, B2); ``KERNEL_VARIANTS`` maps every
counted kernel, B3 included, to its own variant set.
"""
from __future__ import annotations

import ctypes
import numbers
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.flat import LANE

KERNELS = ("dbl_apply_flat2d", "dbl_merge_flat2d")
VARIANTS = ("plain", "vel", "master", "master_vel")
WORKER_VARIANTS = ("plain", "master")
KERNEL_VARIANTS = {**{k: VARIANTS for k in KERNELS},
                   "dbl_apply_worker_flat2d": WORKER_VARIANTS}

_LAUNCHES: Dict[str, Dict[str, int]] = {
    k: dict.fromkeys(vs, 0) for k, vs in KERNEL_VARIANTS.items()}
_PLAIN_RUNS: Dict[str, Dict[str, int]] = {
    k: dict.fromkeys(vs, 0) for k, vs in KERNEL_VARIANTS.items()}


def launch_count(kernel: Optional[str] = None,
                 variant: Optional[str] = None) -> int:
    """CUDA kernel launches so far (all kernels, one kernel, or one
    variant of it)."""
    return _count(_LAUNCHES, kernel, variant)


def plain_count(kernel: Optional[str] = None,
                variant: Optional[str] = None) -> int:
    """Runs of the plain PyTorch versions (CPU tensors) so far."""
    return _count(_PLAIN_RUNS, kernel, variant)


def reset_counts() -> None:
    for table in (_LAUNCHES, _PLAIN_RUNS):
        for per in table.values():
            for v in per:
                per[v] = 0


def _count(table, kernel, variant) -> int:
    kernels = KERNEL_VARIANTS if kernel is None else (kernel,)
    return sum(table[k][v] for k in kernels
               for v in (KERNEL_VARIANTS[k] if variant is None
                         else (variant,)))


def _variant(vel2, master2) -> str:
    if master2 is not None:
        return "master_vel" if vel2 is not None else "master"
    return "vel" if vel2 is not None else "plain"


def _check(p2, grads, vel2, master2):
    """Validate the buffers a kernel will read and write in place."""
    if p2.dim() != 2 or p2.shape[1] != LANE:
        raise ValueError(f"flat buffer must be (rows, {LANE}), got "
                         f"{tuple(p2.shape)}")
    f32 = [*grads] + [t for t in (vel2, master2) if t is not None]
    if master2 is None:
        f32.append(p2)
    elif p2.dtype != torch.bfloat16:
        raise ValueError(f"the master forms keep a bf16 shadow, got "
                         f"{p2.dtype}")
    for t in [p2, *f32]:
        if t.shape != p2.shape:
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(p2.shape)}")
        if t.device != p2.device:
            raise ValueError(f"buffers on {t.device} and {p2.device}")
        if not t.is_contiguous():
            raise ValueError("flat buffers must be contiguous")
        if t.requires_grad:
            raise ValueError("the update writes in place: pass buffers "
                             "outside autograd")
    for t in f32:
        if t.dtype != torch.float32:
            raise ValueError(f"expected float32 buffer, got {t.dtype}")


def _ptr(t: Optional[torch.Tensor], align: int):
    if t is None:
        return None
    p = t.data_ptr()
    if p % align:
        raise ValueError(f"buffer not {align}-byte aligned")
    return ctypes.c_void_p(p)


def _lib():
    from repro_torch.kernels._build import library
    lib = library("dbl_merge")
    if not getattr(lib, "_repro_bound", False):
        vp, f32, i64 = ctypes.c_void_p, ctypes.c_float, ctypes.c_int64
        lib.repro_dbl_apply_flat2d.argtypes = [vp, vp, vp, vp, i64, f32,
                                               f32, vp]
        lib.repro_dbl_apply_flat2d.restype = ctypes.c_int
        lib.repro_dbl_merge_flat2d.argtypes = [vp, vp, vp, vp, vp, i64, f32,
                                               f32, f32, f32, vp]
        lib.repro_dbl_merge_flat2d.restype = ctypes.c_int
        lib.repro_dbl_apply_worker_flat2d.argtypes = [
            vp, vp, vp, vp, i64, ctypes.c_int, f32, f32, f32, vp]
        lib.repro_dbl_apply_worker_flat2d.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _outputs(p2, vel2, master2):
    if master2 is not None:
        return (p2, master2) if vel2 is None else (p2, master2, vel2)
    return p2 if vel2 is None else (p2, vel2)


# -- plain PyTorch versions (separate eager ops, the kernel's op order) ----
def _apply_plain(w, g, vel2, lr, momentum):
    """v' = m·v + g; w' = w − lr·v' — into ``vel2`` / ``w`` in place."""
    if vel2 is not None:
        vel2.copy_(torch.add(torch.mul(vel2, momentum), g))
        g = vel2
    w.copy_(torch.sub(w, torch.mul(g, lr)))


def dbl_apply_plain(p2, g2, *, lr: float, vel2=None, momentum: float = 0.0,
                    master2=None):
    """Plain version of ``dbl_apply_flat2d`` on any device (the kernel's
    reference on the card; the wrapper's CPU path)."""
    w = p2 if master2 is None else master2
    _apply_plain(w, g2, vel2, float(lr), float(momentum))
    if master2 is not None:
        p2.copy_(master2)                  # round-to-nearest-even shadow
    return _outputs(p2, vel2, master2)


def dbl_merge_plain(p2, gl2, gs2, *, factor: float, lr: float, vel2=None,
                    momentum: float = 0.0, master2=None):
    """Plain version of ``dbl_merge_flat2d``: (g_L + f·g_S)·inv, then the
    apply.  ``inv`` is 1/(1+f) taken in double and rounded to f32 once."""
    factor = float(factor)
    inv = 1.0 / (1.0 + factor)
    g = torch.mul(torch.add(gl2, torch.mul(gs2, factor)), inv)
    w = p2 if master2 is None else master2
    _apply_plain(w, g, vel2, float(lr), float(momentum))
    if master2 is not None:
        p2.copy_(master2)
    return _outputs(p2, vel2, master2)


# -- wrappers ---------------------------------------------------------------
def dbl_apply_flat2d(p2, g2, *, lr: float, vel2=None, momentum: float = 0.0,
                     master2=None):
    """ONE server apply over the whole flat store, for a gradient that
    already carries the dual-batch merge (B1):

        v' = m·v + g;   w' = w − lr·v'      (v ≡ g without ``vel2``)

    Updates ``p2`` (and ``vel2``, ``master2``) in place.  With ``master2``
    the update runs on the f32 master and ``p2`` (bf16) receives its
    rounded shadow in the same launch.  Returns ``p2``, ``(p2, vel2)``,
    ``(p2, master2)`` or ``(p2, master2, vel2)`` like the reference.
    """
    _check(p2, (g2,), vel2, master2)
    variant = _variant(vel2, master2)
    if p2.device.type == "cpu":
        _PLAIN_RUNS["dbl_apply_flat2d"][variant] += 1
        return dbl_apply_plain(p2, g2, lr=lr, vel2=vel2, momentum=momentum,
                               master2=master2)
    if p2.device.type != "cuda":
        raise ValueError(f"no dbl_apply_flat2d kernel for {p2.device}")
    w = p2 if master2 is None else master2
    shadow = None if master2 is None else p2
    with torch.cuda.device(p2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().repro_dbl_apply_flat2d(
            _ptr(w, 16), _ptr(shadow, 8), _ptr(g2, 16), _ptr(vel2, 16),
            w.numel(), float(lr), float(momentum), ctypes.c_void_p(stream))
    _raise_on(err, "dbl_apply_flat2d")
    _LAUNCHES["dbl_apply_flat2d"][variant] += 1
    return _outputs(p2, vel2, master2)


def dbl_merge_flat2d(p2, gl2, gs2, *, factor: float, lr: float, vel2=None,
                     momentum: float = 0.0, master2=None):
    """ONE fused merge + apply over the whole flat store (B2):

        g = (g_L + f·g_S)/(1 + f);   v' = m·v + g;   w' = w − lr·v'

    Same in-place / return contract as ``dbl_apply_flat2d``.
    """
    _check(p2, (gl2, gs2), vel2, master2)
    variant = _variant(vel2, master2)
    if p2.device.type == "cpu":
        _PLAIN_RUNS["dbl_merge_flat2d"][variant] += 1
        return dbl_merge_plain(p2, gl2, gs2, factor=factor, lr=lr, vel2=vel2,
                               momentum=momentum, master2=master2)
    if p2.device.type != "cuda":
        raise ValueError(f"no dbl_merge_flat2d kernel for {p2.device}")
    factor = float(factor)
    w = p2 if master2 is None else master2
    shadow = None if master2 is None else p2
    with torch.cuda.device(p2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().repro_dbl_merge_flat2d(
            _ptr(w, 16), _ptr(shadow, 8), _ptr(gl2, 16), _ptr(gs2, 16),
            _ptr(vel2, 16), w.numel(), float(lr), factor,
            1.0 / (1.0 + factor), float(momentum), ctypes.c_void_p(stream))
    _raise_on(err, "dbl_merge_flat2d")
    _LAUNCHES["dbl_merge_flat2d"][variant] += 1
    return _outputs(p2, vel2, master2)


# -- B3: one simulated parameter-server event -------------------------------
def _host_number(x, name: str):
    """A scalar that the host holds (Python or numpy number).  A tensor is
    refused: reading one back would make every event wait for the card."""
    if isinstance(x, torch.Tensor) or not isinstance(
            x, (numbers.Real, np.generic)):
        raise TypeError(f"{name} must be a host number (Python or numpy), "
                        f"got {type(x).__name__}")
    return x


def _worker_args(p2, g2, vel3, wid, lr, factor, momentum, master2):
    """Validate B3's buffers and scalars; returns (wid, lr, factor,
    momentum) as Python numbers."""
    _check(p2, (g2,), None, master2)
    if vel3.dim() != 3 or tuple(vel3.shape[1:]) != tuple(p2.shape):
        raise ValueError(f"stacked velocity must be (n_workers, "
                         f"{p2.shape[0]}, {LANE}), got {tuple(vel3.shape)}")
    if vel3.dtype != torch.float32 or vel3.device != p2.device \
            or not vel3.is_contiguous() or vel3.requires_grad:
        raise ValueError("stacked velocity must be a contiguous float32 "
                         "buffer on the params' device, outside autograd")
    wid = _host_number(wid, "wid")
    if int(wid) != wid or not 0 <= int(wid) < vel3.shape[0]:
        raise ValueError(f"wid {wid} outside [0, {vel3.shape[0]})")
    return (int(wid), float(_host_number(lr, "lr")),
            float(_host_number(factor, "factor")),
            float(_host_number(momentum, "momentum")))


def dbl_apply_worker_plain(p2, g2, vel3, wid, lr, factor, momentum,
                           master2=None):
    """Plain version of ``dbl_apply_worker_flat2d`` (the reference's
    ``dbl_apply_worker_xla``), separate eager ops in the kernel's order:

        v = m·v[wid] + g;   d = (−lr)·v;   w = w + f·d

    into ``vel3[wid]`` and ``p2`` (or ``master2`` and its rounded bf16
    shadow ``p2``) in place.  Returns ``(p2, vel3)`` or
    ``(p2, master2, vel3)``."""
    wid, lr, factor, momentum = int(wid), float(lr), float(factor), \
        float(momentum)
    v = torch.add(torch.mul(vel3[wid], momentum), g2)
    d = torch.mul(v, -lr)
    w = p2 if master2 is None else master2
    w.copy_(torch.add(w, torch.mul(d, factor)))
    vel3[wid].copy_(v)
    if master2 is None:
        return p2, vel3
    p2.copy_(master2)                      # round-to-nearest-even shadow
    return p2, master2, vel3


def dbl_apply_worker_flat2d(p2, g2, vel3, wid, lr, factor, momentum, *,
                            master2=None):
    """ONE fused per-event PS update over the whole flat store (B3).

    p2 / g2: ``(rows, LANE)`` param / gradient buffers; vel3: the stacked
    ``(n_workers, rows, LANE)`` per-worker velocity.  ``wid`` / ``lr`` /
    ``factor`` / ``momentum`` are host numbers (the trace keeps them in
    numpy arrays), passed to the kernel by value, so no event waits for
    the card; a tensor there raises, as does ``wid`` outside
    ``[0, n_workers)``:

        v'[wid] = m·v[wid] + g;   d = −lr·v'[wid];   w' = w + f·d

    Updates ``p2`` and worker ``wid``'s row block of ``vel3`` in place
    (every other worker's rows stay untouched) and returns
    ``(p2, vel3)``.  With ``master2`` the update runs on the f32 master
    and ``p2`` (bf16) receives its rounded shadow in the same launch;
    returns ``(p2, master2, vel3)``.
    """
    wid, lr, factor, momentum = _worker_args(p2, g2, vel3, wid, lr, factor,
                                             momentum, master2)
    variant = "plain" if master2 is None else "master"
    if p2.device.type == "cpu":
        _PLAIN_RUNS["dbl_apply_worker_flat2d"][variant] += 1
        return dbl_apply_worker_plain(p2, g2, vel3, wid, lr, factor,
                                      momentum, master2=master2)
    if p2.device.type != "cuda":
        raise ValueError(f"no dbl_apply_worker_flat2d kernel for "
                         f"{p2.device}")
    w = p2 if master2 is None else master2
    shadow = None if master2 is None else p2
    with torch.cuda.device(p2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().repro_dbl_apply_worker_flat2d(
            _ptr(w, 16), _ptr(shadow, 8), _ptr(g2, 16), _ptr(vel3, 16),
            w.numel(), wid, lr, factor, momentum, ctypes.c_void_p(stream))
    _raise_on(err, "dbl_apply_worker_flat2d")
    _LAUNCHES["dbl_apply_worker_flat2d"][variant] += 1
    return (p2, vel3) if master2 is None else (p2, master2, vel3)


# -- front ends -------------------------------------------------------------
def dbl_merge_tree(params, g_large, g_small, *, factor: float, lr: float):
    """Fused merge over parameter trees — ONE launch for the whole tree
    via the flat-store codec, not one per leaf.  Returns a new tree of
    views into the updated buffer."""
    from repro_torch.core.flat import flat_spec
    spec = flat_spec(params)
    p2 = spec.ravel(params)
    dbl_merge_flat2d(p2, spec.ravel(g_large), spec.ravel(g_small),
                     factor=factor, lr=lr)
    return spec.unravel(p2)
