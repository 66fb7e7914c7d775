"""Data-pipeline primitives: deterministic index streams, per-worker
allocation (dual-batch), and host-side input-size transforms (cyclic
progressive resize/crop).

This module is the low-level math under ``repro_torch.data.plane.DataPlane`` —
pure functions with no state, so both cluster backends (and tests) can
reconstruct any batch from ``(seed, phase, worker, step)`` alone:

  * ``stream_indices``     — THE canonical sample stream: every batch any
    backend consumes is drawn from this counter-keyed PCG64 stream, which
    is what makes PS-sim and SPMD runs comparable sample-for-sample;
  * ``bilinear_resize`` / ``resize_images`` / ``crop_tokens`` — host-side
    resolution adaptation to a phase's ``input_size`` (images resize with
    the shared bilinear kernel; token sequences crop to a prefix, which is
    consistent across sizes because synthetic walks are prefix-stable);
  * ``allocate_worker_indices`` / ``worker_batches`` /
    ``epoch_global_batches`` — the paper §3.3 epoch allocation math.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np

from repro_torch.core.dual_batch import DualBatchPlan


# --------------------------------------------------------------------------
# canonical per-(phase, worker, step) index stream
# --------------------------------------------------------------------------
def stream_indices(n_data: int, n: int, *, seed: int, phase: int, wid: int,
                   step: int) -> np.ndarray:
    """Draw ``n`` sample indices for worker ``wid``'s ``step``-th batch of
    phase ``phase`` — stateless and order-independent: the stream is keyed
    on the full ``(seed, phase, wid, step)`` tuple via ``SeedSequence``, so
    the PS simulator (which draws in event order) and the SPMD engine
    (which draws in global-step order) see IDENTICAL per-worker streams.
    """
    ss = np.random.SeedSequence((seed & 0xFFFFFFFF, phase & 0xFFFFFFFF,
                                 wid & 0xFFFFFFFF, step & 0xFFFFFFFF))
    rng = np.random.Generator(np.random.PCG64(ss))
    return rng.integers(0, n_data, size=n)


# --------------------------------------------------------------------------
# host-side input-size transforms
# --------------------------------------------------------------------------
def bilinear_resize(img: np.ndarray, out: int) -> np.ndarray:
    """Tiny dependency-free bilinear resize, (H, W, C) -> (out, out, C)."""
    h, w, c = img.shape
    ys = np.linspace(0, h - 1, out)
    xs = np.linspace(0, w - 1, out)
    y0 = np.floor(ys).astype(int); y1 = np.minimum(y0 + 1, h - 1)
    x0 = np.floor(xs).astype(int); x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = img[y0][:, x0]; b = img[y0][:, x1]
    cc = img[y1][:, x0]; d = img[y1][:, x1]
    top = a * (1 - wx) + b * wx
    bot = cc * (1 - wx) + d * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def resize_images(imgs: np.ndarray, out: int) -> np.ndarray:
    """(N, H, W, C) -> (N, out, out, C); identity when already at size.
    The result is C-contiguous: ``np.stack`` keeps the resized images'
    W-major layout, and cuDNN picks other kernels (other rounding) for a
    batch laid out so than for the same values in NHWC order."""
    if imgs.shape[1] == out and imgs.shape[2] == out:
        return np.ascontiguousarray(imgs, np.float32)
    return np.ascontiguousarray(
        np.stack([bilinear_resize(im, out) for im in imgs]))


def crop_tokens(toks: np.ndarray, seq: int) -> np.ndarray:
    """(N, S) -> (N, seq) prefix crop — the sequence-axis analogue of the
    image resize (synthetic walks are prefix-stable, so a phase at half
    seq-len trains on genuine prefixes of the full-size stream)."""
    if toks.shape[1] < seq:
        raise ValueError(f"cannot crop {toks.shape[1]} tokens to {seq}")
    return np.asarray(toks[:, :seq])


# --------------------------------------------------------------------------
# epoch allocation math (paper §3.3)
# --------------------------------------------------------------------------
def allocate_worker_indices(plan: DualBatchPlan, n_data: int,
                            epoch: int, seed: int = 0) -> List[np.ndarray]:
    """Split a shuffled epoch permutation into per-worker allocations d_i
    (paper §3.3: d_L per large worker, d_S per small worker).  Rounds to
    integers while preserving the total."""
    rng = np.random.RandomState(seed * 100003 + epoch)
    perm = rng.permutation(n_data)
    sizes = [int(round(plan.d_L))] * plan.n_large \
        + [int(round(plan.d_S))] * plan.n_small
    # fix rounding drift against the real total
    drift = n_data - sum(sizes)
    i = 0
    while drift != 0 and sizes:
        sizes[i % len(sizes)] += 1 if drift > 0 else -1
        drift += -1 if drift > 0 else 1
        i += 1
    out, ofs = [], 0
    for s in sizes:
        out.append(perm[ofs:ofs + s])
        ofs += s
    return out


def worker_batches(indices: np.ndarray, batch_size: int) -> Iterator[np.ndarray]:
    """Yield ceil(d_i / B_i) batches (last one short), per paper Eq. 2."""
    for ofs in range(0, len(indices), batch_size):
        yield indices[ofs:ofs + batch_size]


def epoch_global_batches(n_data: int, global_batch: int, epoch: int,
                         seed: int = 0) -> Iterator[np.ndarray]:
    """SPMD path: shuffled global batches (drop-last)."""
    rng = np.random.RandomState(seed * 100003 + epoch)
    perm = rng.permutation(n_data)
    for ofs in range(0, n_data - global_batch + 1, global_batch):
        yield perm[ofs:ofs + global_batch]
