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
    over the stacked ``(n_workers, rows, LANE)`` velocity;
    ``dbl_apply_worker_batched`` is its candidate-batched form (the
    reference's ``dbl_apply_worker_xla`` under ``jax.vmap``): the same
    event for C autotuner candidates' stores in one launch, each with its
    own lr / factor / momentum read from ``(C,)`` tensors on the card.

B1 and B2 have four variants — plain, ``vel2`` (server momentum),
``master2`` (bf16 shadow + f32 master, written in the same pass) and both;
B3 and its batched form have two, plain and master.  Each runs ONE launch
over the whole ``(rows, LANE)`` buffer (``(C, rows, LANE)`` for the batched
form), updating every output in place over its input, and returns the
updated buffers in the reference's order, so call sites read the same.

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
from typing import Optional

import numpy as np
import torch

from repro_torch.core.flat import LANE
from repro_torch.kernels import _common as _c

KERNELS = ("dbl_apply_flat2d", "dbl_merge_flat2d")
VARIANTS = ("plain", "vel", "master", "master_vel")
WORKER_VARIANTS = ("plain", "master")
KERNEL_VARIANTS = {**{k: VARIANTS for k in KERNELS},
                   "dbl_apply_worker_flat2d": WORKER_VARIANTS,
                   "dbl_apply_worker_batched": WORKER_VARIANTS}

_COUNTS = _c.Counts(KERNEL_VARIANTS)
launch_count = _COUNTS.launch_count     # CUDA kernel launches so far
plain_count = _COUNTS.plain_count       # runs of the plain versions
reset_counts = _COUNTS.reset


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
    shape, dev = p2.shape, p2.device
    for t in [p2, *f32]:
        if t.shape != shape:
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(shape)}")
        if t.device != dev:
            raise ValueError(f"buffers on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("flat buffers must be contiguous")
        if t.requires_grad:
            raise ValueError("the update writes in place: pass buffers "
                             "outside autograd")
    for t in f32:
        if t.dtype != torch.float32:
            raise ValueError(f"expected float32 buffer, got {t.dtype}")


def _ptr(t: Optional[torch.Tensor], align: int) -> Optional[int]:
    if t is None:
        return None
    p = t.data_ptr()
    if p % align:
        raise ValueError(f"buffer not {align}-byte aligned")
    return p


def _launch(dev: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` on ``dev``'s current stream, with ``dev`` the
    current device."""
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


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
        ci = ctypes.c_int
        lib.repro_dbl_apply_worker_batched.argtypes = [
            vp, vp, vp, vp, i64, ci, ci, ci, vp, vp, vp, vp]
        lib.repro_dbl_apply_worker_batched.restype = ctypes.c_int
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
        _COUNTS.plain("dbl_apply_flat2d", variant)
        return dbl_apply_plain(p2, g2, lr=lr, vel2=vel2, momentum=momentum,
                               master2=master2)
    if p2.device.type != "cuda":
        raise ValueError(f"no dbl_apply_flat2d kernel for {p2.device}")
    w = p2 if master2 is None else master2
    shadow = None if master2 is None else p2
    err = _launch(p2.device, _lib().repro_dbl_apply_flat2d, _ptr(w, 16),
                  _ptr(shadow, 8), _ptr(g2, 16), _ptr(vel2, 16), w.numel(),
                  float(lr), float(momentum))
    _raise_on(err, "dbl_apply_flat2d")
    _COUNTS.launch("dbl_apply_flat2d", variant)
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
        _COUNTS.plain("dbl_merge_flat2d", variant)
        return dbl_merge_plain(p2, gl2, gs2, factor=factor, lr=lr, vel2=vel2,
                               momentum=momentum, master2=master2)
    if p2.device.type != "cuda":
        raise ValueError(f"no dbl_merge_flat2d kernel for {p2.device}")
    factor = float(factor)
    w = p2 if master2 is None else master2
    shadow = None if master2 is None else p2
    err = _launch(p2.device, _lib().repro_dbl_merge_flat2d, _ptr(w, 16),
                  _ptr(shadow, 8), _ptr(gl2, 16), _ptr(gs2, 16),
                  _ptr(vel2, 16), w.numel(), float(lr), factor,
                  1.0 / (1.0 + factor), float(momentum))
    _raise_on(err, "dbl_merge_flat2d")
    _COUNTS.launch("dbl_merge_flat2d", variant)
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
        _COUNTS.plain("dbl_apply_worker_flat2d", variant)
        return dbl_apply_worker_plain(p2, g2, vel3, wid, lr, factor,
                                      momentum, master2=master2)
    if p2.device.type != "cuda":
        raise ValueError(f"no dbl_apply_worker_flat2d kernel for "
                         f"{p2.device}")
    w = p2 if master2 is None else master2
    shadow = None if master2 is None else p2
    err = _launch(p2.device, _lib().repro_dbl_apply_worker_flat2d,
                  _ptr(w, 16), _ptr(shadow, 8), _ptr(g2, 16), _ptr(vel3, 16),
                  w.numel(), wid, lr, factor, momentum)
    _raise_on(err, "dbl_apply_worker_flat2d")
    _COUNTS.launch("dbl_apply_worker_flat2d", variant)
    return (p2, vel3) if master2 is None else (p2, master2, vel3)


# -- B3 over C autotuner candidates in one launch ---------------------------
def _batched_args(pC, gC, velC, wid, lrC, facC, momC, masterC) -> int:
    """Validate the batched form's buffers and per-candidate scalars;
    returns ``wid`` as a Python int."""
    if pC.dim() != 3 or pC.shape[2] != LANE:
        raise ValueError(f"candidate buffers must be (C, rows, {LANE}), got "
                         f"{tuple(pC.shape)}")
    bufs = [pC, gC, velC] + ([] if masterC is None else [masterC])
    if not all(t.is_contiguous() for t in bufs):
        raise ValueError("flat buffers must be contiguous")
    for t in (gC, masterC):
        if t is not None and t.shape != pC.shape:
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(pC.shape)}")
    _check(pC.view(-1, LANE), (gC.view(-1, LANE),), None,
           None if masterC is None else masterC.view(-1, LANE))
    n_cand = pC.shape[0]
    if not 1 <= n_cand <= 65535:          # the kernel's grid.y
        raise ValueError(f"{n_cand} candidates outside [1, 65535]")
    if velC.dim() != 4 or velC.shape[0] != n_cand \
            or tuple(velC.shape[2:]) != tuple(pC.shape[1:]):
        raise ValueError(f"candidate velocity must be ({n_cand}, n_workers, "
                         f"{pC.shape[1]}, {LANE}), got {tuple(velC.shape)}")
    if velC.dtype != torch.float32 or velC.device != pC.device \
            or velC.requires_grad:
        raise ValueError("candidate velocity must be a float32 buffer on "
                         "the params' device, outside autograd")
    for name, t in (("lrC", lrC), ("facC", facC), ("momC", momC)):
        if not isinstance(t, torch.Tensor) or t.shape != (n_cand,) \
                or t.dtype != torch.float32 or t.device != pC.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor of "
                             f"{n_cand} values on {pC.device}")
    wid = _host_number(wid, "wid")
    if int(wid) != wid or not 0 <= int(wid) < velC.shape[1]:
        raise ValueError(f"wid {wid} outside [0, {velC.shape[1]})")
    return int(wid)


def dbl_apply_worker_batched_plain(pC, gC, velC, wid, lrC, facC, momC,
                                   masterC=None):
    """Plain version of ``dbl_apply_worker_batched``: C calls of
    ``dbl_apply_worker_plain``, candidate c on ``pC[c]``, ``gC[c]``,
    ``velC[c]`` (and ``masterC[c]``) at ``lrC[c]``, ``facC[c]``,
    ``momC[c]``.  Returns ``(pC, velC)`` or ``(pC, masterC, velC)``."""
    for c in range(pC.shape[0]):
        dbl_apply_worker_plain(
            pC[c], gC[c], velC[c], wid, float(lrC[c]), float(facC[c]),
            float(momC[c]), master2=None if masterC is None else masterC[c])
    return (pC, velC) if masterC is None else (pC, masterC, velC)


def dbl_apply_worker_batched(pC, gC, velC, wid, lrC, facC, momC, *,
                             masterC=None):
    """B3 for C candidates in ONE launch (the batched candidate replay's
    per-event update):

        v'[c, wid] = m[c]·v[c, wid] + g[c];   d = −lr[c]·v'[c, wid];
        w'[c] = w[c] + f[c]·d

    pC / gC: ``(C, rows, LANE)``; velC: ``(C, n_workers, rows, LANE)``
    f32; ``wid``: one host int, a timeline fact shared by every
    candidate; lrC / facC / momC: ``(C,)`` float32 tensors on the
    buffers' device, read by the kernel and never by the host.  Each
    candidate gets exactly B3's function in B3's float order, so the
    result is bit-equal to C calls of ``dbl_apply_worker_flat2d`` with
    those scalars.  Updates ``pC`` and row block ``(c, wid)`` of ``velC``
    in place and returns ``(pC, velC)``; with ``masterC`` the update runs
    on the f32 masters and ``pC`` (bf16) receives their rounded shadows,
    returning ``(pC, masterC, velC)``.
    """
    wid = _batched_args(pC, gC, velC, wid, lrC, facC, momC, masterC)
    kernel = "dbl_apply_worker_batched"
    variant = "plain" if masterC is None else "master"
    if pC.device.type == "cpu":
        _COUNTS.plain(kernel, variant)
        return dbl_apply_worker_batched_plain(pC, gC, velC, wid, lrC, facC,
                                              momC, masterC=masterC)
    if pC.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for {pC.device}")
    w = pC if masterC is None else masterC
    shadow = None if masterC is None else pC
    err = _launch(pC.device, _lib().repro_dbl_apply_worker_batched,
                  _ptr(w, 16), _ptr(shadow, 8), _ptr(gC, 16), _ptr(velC, 16),
                  w[0].numel(), pC.shape[0], velC.shape[1], wid,
                  _ptr(lrC, 4), _ptr(facC, 4), _ptr(momC, 4))
    _raise_on(err, kernel)
    _COUNTS.launch(kernel, variant)
    return (pC, velC) if masterC is None else (pC, masterC, velC)


# -- front ends -------------------------------------------------------------
def dbl_merge_leaf(p, gl, gs, *, factor: float, lr: float):
    """B2 on one leaf, in place: ONE ``dbl_merge_flat2d`` launch over the
    leaf (a DTensor's local shard; ``g_L`` / ``g_S`` first placed as the
    leaf is, so the elementwise update on shards is exact).  A contiguous
    f32 shard whose size is a multiple of ``LANE`` runs as its own
    ``(rows, LANE)`` view; any other goes through a zero-padded copy in
    the store layout (``padded_rows``, the reference's ``dbl_merge_flat``)
    and is copied back.  Returns ``p``."""
    from repro_torch.core.dtensor import local, place_like
    from repro_torch.core.flat import padded_rows
    w = local(p)
    a = local(place_like(gl, p)).contiguous()
    b = local(place_like(gs, p)).contiguous()
    n = w.numel()
    if w.is_contiguous() and n % LANE == 0 and n:
        dbl_merge_flat2d(w.view(-1, LANE), a.view(-1, LANE),
                         b.view(-1, LANE), factor=factor, lr=lr)
        return p
    rows = padded_rows(n)

    def pad(t):
        buf = torch.zeros(rows * LANE, dtype=t.dtype, device=t.device)
        buf[:n].copy_(t.reshape(-1))
        return buf.view(rows, LANE)

    w2 = pad(w)
    dbl_merge_flat2d(w2, pad(a), pad(b), factor=factor, lr=lr)
    w.copy_(w2.view(-1)[:n].view(w.shape))
    return p


def dbl_merge_tree(params, g_large, g_small, *, factor: float, lr: float,
                   leafwise: bool = False):
    """Fused merge over parameter trees — ONE launch for the whole tree
    via the flat-store codec, not one per leaf.  Returns a new tree of
    views into the updated buffer.

    ``leafwise=True`` runs B2 once per leaf instead, in place on each
    leaf (``dbl_merge_leaf``): the form for a DTensor tree, whose leaves'
    local shards cannot be raveled into one global store."""
    from repro_torch.core.dtensor import is_dtensor
    from repro_torch.core.flat import flat_spec
    from repro_torch.core.tree import tree_leaves
    if leafwise:
        for p, gl, gs in zip(tree_leaves(params), tree_leaves(g_large),
                             tree_leaves(g_small)):
            dbl_merge_leaf(p, gl, gs, factor=factor, lr=lr)
        return params
    if any(is_dtensor(p) for p in tree_leaves(params)):
        raise ValueError("a DTensor tree cannot ravel into one store: pass "
                         "leafwise=True")
    spec = flat_spec(params)
    p2 = spec.ravel(params)
    dbl_merge_flat2d(p2, spec.ravel(g_large), spec.ravel(g_small),
                     factor=factor, lr=lr)
    return spec.unravel(p2)
