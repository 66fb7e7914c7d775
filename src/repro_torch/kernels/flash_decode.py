"""One-query decode attention over a KV cache (the serving hot spot).

Two kernels, hand-written in CUDA for Hopper (``csrc/flash_decode.cu``),
replace the reference's Pallas TPU kernels.  Both split each row's live
keys over the blocks of a thread-block cluster (``split``; by default
``decode_cluster_size`` / ``cluster_size`` choose from the grid, the SM
count and the cache length), one block serving a KV head's query heads
from keys it stages in shared memory, and the cluster's leader merges the
partial softmax states through distributed shared memory:

  * ``flash_decode`` (B5) — q ``(B, H, 1, hd)`` over a cache
    ``(B, KV, S, hd)`` of any 16-byte-aligned strides with a contiguous
    last dimension (the reference's contiguous form, or the
    ``transpose(1, 2)`` view of the models' ``(B, S, KV, hd)`` layer
    cache, read in place) and one position ``pos``: a host int, or a 0-d
    int32 tensor on q's device that the kernel reads from device memory
    (as the Pallas kernel reads its scalar-prefetch operand), so that its
    launch arguments stay the same from one decode step to the next; head
    dims a multiple of 16 up to 256;
  * ``flash_decode_paged`` (B6) — q ``(S, H, 1, hd)`` over a page pool
    ``(P, page_len, KV, hd)`` through a page table ``(S, PP)`` and
    per-row ``lengths`` ``(S,)``: the paged serve step's decode attention;
    head dims a multiple of 32 up to 256 (its 16-byte row chunks and
    4-lane key split are laid out for that).

Both attend to the keys ``j <= pos`` (and ``j > pos - window`` when
``window > 0``), with the KV head ``h // n_rep`` (GQA), softmax in f32,
the output in q's dtype.  Page ids are clamped to ``[0, P - 1]`` before
they are read, as the JAX gather of the reference's CPU path clamps them:
the serving engine fills unowned table entries with the sentinel ``P``.

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor — and only then — it runs the plain PyTorch version
(``paged_decode_ref`` / ``_xla_decode``), which the kernel matches within
a tolerance (the softmax's order and ``exp`` differ).  ``launch_count``
counts kernel launches, ``plain_count`` runs of the plain versions;
``KERNEL_VARIANTS`` maps each kernel to its variants, named by the cache
dtype (``f32``, ``bf16``).  Under a cost count (``launch.hlo_analysis``)
a B5 launch adds its own work, ``flash_decode_work``, and meta tensors
take B5's checks and the meta route (``_common.meta_launch``,
``meta_count``); outside a count they are refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _common as _c
from repro_torch.kernels.ref import NEG_INF, flash_decode_ref

KERNEL_VARIANTS = {"flash_decode": ("f32", "bf16"),
                   "flash_decode_paged": ("f32", "bf16")}

_COUNTS = _c.Counts(KERNEL_VARIANTS)
launch_count = _COUNTS.launch_count     # CUDA kernel launches so far
plain_count = _COUNTS.plain_count       # runs of the plain versions
meta_count = _COUNTS.meta_count         # meta stand-ins under a cost count
reset_counts = _COUNTS.reset

MAX_HEAD_DIM = 256

# B5 and B6 split each row's live keys over the blocks of a thread-block
# cluster, in stages of keys
CLUSTER_SIZES = (1, 2, 4, 8)
STAGE_KEYS = 32          # keys a B6 block stages at a time (csrc kStageKeys)
_STAGES, _WARPS = 3, 4   # B6's ring (csrc paged::kStages), warps a block
# B5 (csrc dense::): its ring's target bytes and most stages, and the
# least K/V bytes a block should stream
_RING_TARGET, _MAX_STAGES = 65536, 4
_MIN_BLOCK_BYTES = 96 * 1024
_SMEM_PER_SM = 233472    # bytes of shared memory an H100 SM gives its blocks
_SM_COUNT = {}


def _group(n_rep: int) -> int:
    """Query heads a block serves (csrc ``dispatch``: kRep)."""
    return 1 if n_rep == 1 else 2 if n_rep == 2 else 4 if n_rep <= 4 else 8


def _block_smem(hd: int, kv_bytes: int, rep: int) -> int:
    """A block's shared memory (csrc ``Smem::bytes``): q, then the larger
    of the K/V ring and the warps' partial states."""
    ring = 2 * _STAGES * STAGE_KEYS * hd * kv_bytes
    return rep * hd * 4 + max(ring, _WARPS * rep * (hd + 2) * 4)


def _dense_warps(hd: int, kv_bytes: int) -> int:
    """Warps of a B5 block (csrc ``dense::block_warps``), 8 keys each a
    stage: 8, or 4 for f32 rows of more than 128 dims."""
    return 4 if kv_bytes == 4 and hd > 128 else 8


def _dense_smem(hd: int, kv_bytes: int, rep: int) -> int:
    """A B5 block's shared memory (csrc ``dense::smem_bytes``): q, then
    the larger of the ring — 2 to 4 stages of K and V rows, as many as
    fit 64 KB, each row padded so that rows start 64 bytes apart modulo
    128 — and the warps' and the block's partial states."""
    warps = _dense_warps(hd, kv_bytes)
    row = hd * kv_bytes
    pitch = row + (192 - row % 128) % 128
    stage = 2 * 8 * warps * pitch
    stages = min(_MAX_STAGES, max(2, _RING_TARGET // stage))
    q = -(-rep * hd * 4 // 16) * 16
    return q + max(stages * stage, (warps + 1) * rep * (hd + 2) * 4)


@functools.lru_cache(maxsize=256)
def cluster_size(rows: int, heads: int, kv_heads: int, n_keys: int,
                 n_sm: int, hd: int, kv_bytes: int) -> int:
    """The blocks of B6's cluster a row's keys are split over: the fewest of
    ``CLUSTER_SIZES`` that give the grid two thirds of the blocks the SMs
    hold at once (by shared memory, at most 8 an SM), and no more than one
    stage of ``STAGE_KEYS`` keys a block at the longest row (``n_keys``
    keys).  A block serves one KV head's query heads, up to 8 of them;
    ``hd`` and ``kv_bytes`` (a page element's size) set its shared
    memory."""
    rep = _group(heads // kv_heads)
    clusters = rows * kv_heads * -(-(heads // kv_heads) // rep)
    per_sm = max(1, min(8, _SMEM_PER_SM // (_block_smem(hd, kv_bytes, rep)
                                             + 1024)))
    target = 2 * per_sm * n_sm / 3
    most = -(-n_keys // STAGE_KEYS)
    for c in CLUSTER_SIZES:
        if clusters * c >= target or 2 * c > most:
            return c
    return CLUSTER_SIZES[-1]


@functools.lru_cache(maxsize=256)
def decode_cluster_size(rows: int, heads: int, kv_heads: int, n_keys: int,
                        n_sm: int, hd: int, kv_bytes: int,
                        window: int = 0) -> int:
    """The blocks of B5's cluster a row's keys are split over: the most of
    ``CLUSTER_SIZES`` that keep every block of the grid resident at once
    and give each block at least ``_MIN_BLOCK_BYTES`` of K and V at the
    longest live range (``n_keys``, the cache's length, or ``window`` when
    it is shorter); 1 when even 2 would not.  Past one wave of blocks the
    tail wave costs, and a shorter share costs a block its fixed latency
    (the first stage, the merge) for less streaming.  Resident: by shared
    memory, at most 8 blocks an SM; where one block fills an SM, clusters
    of at most 4 on at most three quarters of the SMs, since a cluster's
    blocks share one GPC of 14-18 SMs and a full card leaves some
    clusters to a second wave.  Read from the cache's length and the
    layer's window, never from ``pos``, so that a decode step launches B5
    with the same arguments at every position."""
    rep = _group(heads // kv_heads)
    clusters = rows * kv_heads * -(-(heads // kv_heads) // rep)
    per_sm = max(1, min(8, _SMEM_PER_SM
                        // (_dense_smem(hd, kv_bytes, rep) + 1024)))
    stage_keys = 8 * _dense_warps(hd, kv_bytes)
    live = min(n_keys, window) if window > 0 else n_keys
    n_st = -(-live // stage_keys)
    stage = 2 * stage_keys * hd * kv_bytes
    slots = per_sm * n_sm if per_sm > 1 else 3 * n_sm // 4
    best = 1
    for c in CLUSTER_SIZES[1:]:
        if clusters * c <= slots and (per_sm > 1 or c <= 4) and \
                -(-n_st // c) * stage >= _MIN_BLOCK_BYTES:
            best = c
    return best


def _sm_count(device) -> int:
    idx = torch.device(device).index or 0
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def resolve_impl(impl: str, device) -> str:
    """``"auto"`` -> ``"cuda"`` (the kernel) for a CUDA device, ``"plain"``
    (the PyTorch version) for the CPU — the wrappers' own rule, which the
    serve step reads to decide whether the kernel takes a decode tick.
    An explicit ``"cuda"`` or ``"plain"`` is returned when the device can
    run it, and refused otherwise."""
    dev = torch.device(device).type
    if impl == "auto":
        return "cuda" if dev == "cuda" else "plain"
    if (impl, dev) in (("cuda", "cuda"), ("plain", "cpu")):
        return impl
    raise ValueError(f"impl {impl!r} cannot run on {dev}: the kernel needs "
                     "CUDA tensors, the plain version runs for CPU tensors")


def live_keys(pos, n_keys: int, window: int = 0) -> int:
    """Keys one row attends to at position ``pos`` (a host int) over a
    cache of ``n_keys``: ``j <= pos``, within the last ``window`` when
    ``window > 0``.  A tensor ``pos`` is not read (that would wait on the
    card, and a meta one has no value): the row counts at the cache's
    last position, the decode step its shapes describe."""
    if isinstance(pos, torch.Tensor):
        pos = n_keys - 1
    hi = min(pos, n_keys - 1)
    lo = max(0, pos - window + 1) if window > 0 else 0
    return max(0, hi - lo + 1)


def flash_decode_work(q, k_cache, pos, *, window: int = 0):
    """(FLOPs, bytes) of one B5 call, the bound's formula: each live K and
    V row read once (``live_keys``), q read and the output written once;
    4·hd operations a (query head, live key)."""
    rows, h, _, hd = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    live = live_keys(pos, s, int(window)) * rows
    nbytes = live * kvh * hd * 2 * k_cache.element_size() \
        + 2 * q.numel() * q.element_size()
    return live * h * hd * 4, nbytes


# -- plain PyTorch versions --------------------------------------------------
def _xla_decode(q, k_cache, v_cache, pos, *, window: int = 0):
    """Plain form of ``flash_decode`` (the reference's XLA form; the same
    math as ``ref.flash_decode_ref``)."""
    return flash_decode_ref(q, k_cache, v_cache, pos, window=window)


def paged_decode_ref(q, k_pages, v_pages, page_table, lengths, *,
                     window: int = 0):
    """Plain form of ``flash_decode_paged``: gather each row's pages into
    logical order (page ids clamped to the pool, as JAX's gather clamps),
    then the contiguous decode attention with per-row lengths."""
    ns, h, _, hd = q.shape
    n_pages, page_len, kvh = k_pages.shape[:3]
    pp = page_table.shape[1]
    s = pp * page_len
    tbl = page_table.long().clamp(0, n_pages - 1)
    k = k_pages[tbl].reshape(ns, s, kvh, hd)
    v = v_pages[tbl].reshape(ns, s, kvh, hd)
    n_rep = h // kvh
    k = torch.repeat_interleave(k.transpose(1, 2), n_rep, dim=1)  # (S,H,s,hd)
    v = torch.repeat_interleave(v.transpose(1, 2), n_rep, dim=1)
    sc = torch.einsum("bhqd,bhsd->bhqs", q.float(), k.float()) * hd ** -0.5
    idx = torch.arange(s, device=q.device)
    lens = lengths.long()
    valid = idx[None, :] <= lens[:, None]                         # (S, s)
    if window > 0:
        valid = torch.logical_and(valid,
                                  idx[None, :] > lens[:, None] - window)
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqs,bhsd->bhqd", p, v.float()).to(q.dtype)


# -- checks and the library ---------------------------------------------------
def _check_qkv(name, q, k, v, n_kv_heads: int, hd_step: int):
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"{name}: q must be (rows, H, 1, hd), got "
                         f"{tuple(q.shape)}")
    h, hd = q.shape[1], q.shape[3]
    if k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError(f"{name}: k {tuple(k.shape)} {k.dtype} and v "
                         f"{tuple(v.shape)} {v.dtype} differ")
    if q.dtype not in _c.FLOATS or k.dtype not in _c.FLOATS:
        raise ValueError(f"{name}: q and the cache must be float32 or "
                         f"bfloat16, got {q.dtype} / {k.dtype}")
    if k.shape[-1] != hd:
        raise ValueError(f"{name}: head dim {k.shape[-1]} != q's {hd}")
    if n_kv_heads < 1 or h % n_kv_heads:
        raise ValueError(f"{name}: {h} query heads over {n_kv_heads} KV "
                         "heads")
    if hd % hd_step or not hd_step <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {hd} is not a multiple of "
                         f"{hd_step} up to {MAX_HEAD_DIM}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {q.device} and {t.device}")


def _contiguous(name, *ts):
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel reads contiguous tensors; "
                             f"got strides {t.stride()} for shape "
                             f"{tuple(t.shape)}")


def _lib():
    from repro_torch.kernels._build import library
    lib = library("flash_decode")
    if not getattr(lib, "_repro_bound", False):
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        i64 = ctypes.c_longlong
        lib.repro_flash_decode.argtypes = [vp, vp, vp, vp] + [i32] * 6 + [
            vp, i32, f32, i32, i32, i64, i64, i64, i32, vp]
        lib.repro_flash_decode.restype = ctypes.c_int
        lib.repro_flash_decode_paged.argtypes = [vp] * 6 + [i32] * 8 + [
            f32, i32, i32, i32, vp]
        lib.repro_flash_decode_paged.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def _is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


# -- wrappers ----------------------------------------------------------------
def flash_decode(q, k_cache, v_cache, pos, *, window: int = 0, split=None):
    """q: (B, H, 1, hd); k_cache/v_cache: (B, KV, S, hd), one layout (the
    same strides; the last dimension contiguous; e.g. ``cache.transpose(1,
    2)`` of a ``(B, S, KV, hd)`` cache, which the kernel reads in place);
    ``pos``: the index of the newest token (keys ``0..pos`` attend, within
    the last ``window`` when ``window > 0``), a host int ``>= 0`` or a 0-d
    int32 tensor on q's device, which the kernel reads on the card (no
    copy to the host: the caller keeps ``0 <= pos``); the plain version
    gives the same bits for both.  Returns (B, H, 1, hd) in q's dtype
    (B5); hd a multiple of 16 up to 256.

    ``split``: the blocks of the kernel's cluster that share a row's keys
    (one of ``CLUSTER_SIZES``; ``None`` chooses by
    ``decode_cluster_size``, from the cache's length and the window, not
    from ``pos``).  It changes the float order only; the plain version does
    not read it."""
    name = "flash_decode"
    if split is not None and split not in CLUSTER_SIZES:
        raise ValueError(f"{name}: split must be one of {CLUSTER_SIZES} or "
                         f"None, got {split!r}")
    _check_qkv(name, q, k_cache, v_cache, k_cache.shape[1], 16)
    if k_cache.dim() != 4 or k_cache.shape[0] != q.shape[0]:
        raise ValueError(f"{name}: caches must be (B, KV, S, hd) with q's "
                         f"B, got {tuple(k_cache.shape)}")
    pos = _c.position(name, "pos", pos, q.device)
    window = int(window)
    variant = _c.variant_of(k_cache)
    if q.device.type == "cpu":
        _COUNTS.plain(name, variant)
        return _xla_decode(q, k_cache, v_cache, pos, window=window)
    if q.device.type != "cuda" and not _c.counted_meta(q):
        raise ValueError(f"no {name} kernel for {q.device}")
    _contiguous(name, q)
    for label, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _c.check_last_contiguous(name, label, t)
    strides = _c.strides_of(k_cache, (0, 1, 2))
    if _c.strides_of(v_cache, (0, 1, 2)) != strides:
        raise ValueError(f"{name}: k and v caches must share one layout; got "
                         f"strides {k_cache.stride()} and {v_cache.stride()}")
    if not 0 < strides[2] < 2 ** 31:
        raise ValueError(f"{name}: the kernel takes a key stride of 1 to "
                         f"2^31 - 1 elements; got {strides[2]}")
    esz = k_cache.element_size()
    for t in (k_cache, v_cache):
        if t.data_ptr() % 16 or any(st * esz % 16 for st in strides):
            raise ValueError(f"{name}: the kernel copies cache rows in "
                             "16-byte pieces and needs 16-byte-aligned rows; "
                             f"got strides {t.stride()} and base offset "
                             f"{t.data_ptr() % 16}")
    work = lambda: flash_decode_work(q, k_cache, pos, window=window)
    if q.device.type == "meta":
        return _c.meta_launch(_COUNTS, name, variant, torch.empty_like(q),
                              work)
    b, h, _, hd = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    if split is None:
        split = decode_cluster_size(b, h, kvh, s, _sm_count(q.device), hd,
                                    esz, window)
    host_pos, pos_ptr = (pos, None) if isinstance(pos, int) else \
        (0, _c.ptr(pos))
    out = torch.empty_like(q)
    err = _lib().repro_flash_decode(
        _c.ptr(q), _c.ptr(k_cache), _c.ptr(v_cache), _c.ptr(out), b, h, kvh,
        s, hd, host_pos, pos_ptr, window, hd ** -0.5, _is_bf16(q),
        _is_bf16(k_cache), *strides, int(split), _c.stream_of(q))
    _c.raise_on(err, name)
    _COUNTS.launch(name, variant)
    _c.add_work(name, work)
    return out


def flash_decode_paged(q, k_pages, v_pages, page_table, lengths, *,
                       window: int = 0, split=None):
    """Paged decode attention (B6): one query token per row over a
    block-paged KV pool, each key read straight from its pool page through
    the page table — no gather materializes.

    q:          (S, H, 1, hd)         one new token per serving row
    k/v_pages:  (P, page_len, KV, hd) the page pool (one layer's pages)
    page_table: (S, PP) int32         pool page id of each logical page
                                      (ids past the pool read page P - 1)
    lengths:    (S,) int32            per-row position of the newest token
                                      (mask: logical index <= lengths[s]),
                                      within ``[0, PP * page_len)``

    ``split``: the blocks of the kernel's cluster that share a row's keys
    (one of ``CLUSTER_SIZES``; ``None`` chooses by ``cluster_size``).  It
    changes the float order only; the plain version does not read it.

    Returns (S, H, 1, hd) in q's dtype."""
    name = "flash_decode_paged"
    if split is not None and split not in CLUSTER_SIZES:
        raise ValueError(f"{name}: split must be one of {CLUSTER_SIZES} or "
                         f"None, got {split!r}")
    _check_qkv(name, q, k_pages, v_pages, k_pages.shape[2], 32)
    ns = q.shape[0]
    if k_pages.dim() != 4:
        raise ValueError(f"{name}: pages must be (P, page_len, KV, hd), got "
                         f"{tuple(k_pages.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != ns \
            or tuple(lengths.shape) != (ns,):
        raise ValueError(f"{name}: table {tuple(page_table.shape)} and "
                         f"lengths {tuple(lengths.shape)} must be "
                         f"({ns}, PP) and ({ns},)")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: table and lengths must be int32")
    for t in (page_table, lengths):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {q.device} and {t.device}")
    window = int(window)
    variant = _c.variant_of(k_pages)
    if q.device.type == "cpu":
        _COUNTS.plain(name, variant)
        return paged_decode_ref(q, k_pages, v_pages, page_table, lengths,
                                window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no {name} kernel for {q.device}")
    _contiguous(name, q, k_pages, v_pages, page_table, lengths)
    for t in (k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel copies pages in 16-byte "
                             "pieces and needs 16-byte-aligned pools; got "
                             f"base offset {t.data_ptr() % 16}")
    h, hd = q.shape[1], q.shape[3]
    n_pages, page_len, kvh = k_pages.shape[:3]
    pp = page_table.shape[1]
    if split is None:
        split = cluster_size(ns, h, kvh, pp * page_len, _sm_count(q.device),
                             hd, k_pages.element_size())
    out = torch.empty_like(q)
    err = _lib().repro_flash_decode_paged(
        _c.ptr(q), _c.ptr(k_pages), _c.ptr(v_pages), _c.ptr(page_table),
        _c.ptr(lengths), _c.ptr(out), ns, h, kvh, hd, page_len, pp, n_pages,
        window, hd ** -0.5, _is_bf16(q), _is_bf16(k_pages), int(split),
        _c.stream_of(q))
    _c.raise_on(err, name)
    _COUNTS.launch(name, variant)
    return out
