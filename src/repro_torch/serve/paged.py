"""Block-paged KV cache + the batched serve steps.

Each attention layer owns a fixed pool of ``(n_pages, page_len, kv_heads,
head_dim)`` blocks, and a per-slot *page table* maps logical token
positions to pool pages.  Admission is then a page-budget check, eviction
returns pages, and the pool's token axis follows the flat store's
sublane-tile rule (``flat.sublane_for`` / ``flat.padded_len``).

Two kinds of step share ONE attention-math path (`_slot_attention`):

  * ``backend="paged"``   — gather KV through the page table (plain
    PyTorch), or, for a one-token decode tick on the card with a uniform
    window, stream pages with the hand-written kernel
    ``kernels.flash_decode.flash_decode_paged`` (no gather materializes);
  * ``backend="contig"``  — classic per-slot contiguous cache, reading the
    cache directly.

The two backends differ only in how bytes are addressed: the values
entering the attention math are identical, and masked positions
contribute an exact ``0.0`` (scores hit ``NEG_INF``, the shifted ``exp``
underflows to zero, and ``0 x finite == 0``), so paged and contiguous
logits of the plain path are *bit-identical* in f32 when the logical
extents match (``contig`` token axis == ``pages_per_slot * page_len``).

Steps are batched over ``m`` slot rows and ``T`` chunk tokens; one
step family serves decode ``(m, 1)``, chunked prefill ``(1, C)`` and the
speculative verify chunk ``(m, k+1)``.  ``active`` carries a per-row
*valid token count* (0 = dead row): rows write exactly their first
``active[i]`` positions to the KV cache.

The per-tick inputs (``rows``, ``lengths``, ``active``, ``tokens``) are
host numpy arrays: the step works out on the host which cache positions
take a write — the reference's ``mode="drop"`` scatter drops page ids past
the pool and positions past ``slot_tokens``; here they never reach the
device — and copies its index tensors to the card once per tick, not once
per layer.  The caches are updated in place (the reference donates them).
Layers run as a Python loop over each segment's stacked tensors, indexed
as views, so a decode tick on the card makes one B6 launch per layer.  An
MoE model's FFN runs ``moe_ffn`` dropless on the tick's packed ``(m, T)``
tokens, so a token's output does not depend on the rows beside it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.core import flat, prng
from repro_torch.kernels import flash_decode as fd
from repro_torch.models.attention import NEG_INF, attn_project_qkv, gqa_expand
from repro_torch.models.layers import dtype_of, rms_norm, rope_tables, swiglu
from repro_torch.models.moe import moe_ffn
from repro_torch.models.transformer import Segment, layout


def attention_segments(cfg: ModelConfig) -> Tuple[Segment, ...]:
    """The layer layout, validated to be servable by the paged engine.

    Paged KV needs KV-cache semantics per layer; recurrent segments
    (mamba2 / rwkv6) carry dense states and the weight-tied shared block
    would need its own one-layer pool — both stay on the static
    ``launch.serve.generate`` path.
    """
    segs = layout(cfg)
    bad = sorted({s.kind for s in segs if s.kind != ATTN})
    if bad:
        raise ValueError(
            f"paged serving supports attention-only stacks; found segments "
            f"{bad} — use the static generate path for this arch")
    return segs


@dataclass(frozen=True)
class PageSpec:
    """Geometry of the paged KV pool (shared by every attention layer).

    ``page_len`` must be a multiple of the store dtype's sublane tile
    (``flat.sublane_for``): 8 tokens for f32, 16 for bf16.  ``n_pages``
    defaults to ``n_slots * pages_per_slot`` (enough for every slot to be
    full); an oversubscribed pool (smaller ``n_pages``) makes admission
    contend for pages.  ``store_dtype`` is a torch dtype.
    """
    page_len: int = 16
    pages_per_slot: int = 8
    n_slots: int = 4
    n_pages: int = 0                      # 0 -> n_slots * pages_per_slot
    store_dtype: Any = torch.float32

    def __post_init__(self):
        sub = flat.sublane_for(self.store_dtype)
        if self.page_len % sub or self.page_len <= 0:
            raise ValueError(
                f"page_len={self.page_len} is not a {self.store_dtype} "
                f"store tile; use a multiple of {sub} "
                f"(flat.padded_len({self.page_len}) = "
                f"{flat.padded_len(self.page_len, self.store_dtype)})")
        if self.n_pages == 0:
            object.__setattr__(self, "n_pages",
                               self.n_slots * self.pages_per_slot)

    @property
    def slot_tokens(self) -> int:
        """Max logical tokens one slot can address (its table's reach)."""
        return self.pages_per_slot * self.page_len

    def pages_needed(self, prompt_len: int, max_new: int,
                     prefill_chunk: int) -> int:
        """Pages a request must hold before admission: the padded prefill
        extent (``ceil(P / C) * C``) plus the decode tokens."""
        c = max(1, int(prefill_chunk))
        padded = -(-max(1, int(prompt_len)) // c) * c
        return -(-(padded + max(0, int(max_new))) // self.page_len)

    def pool_bytes(self, cfg: ModelConfig) -> int:
        """Total KV pool bytes across layers (what bf16 pages halve)."""
        n_layers = sum(s.count for s in attention_segments(cfg))
        per = (self.n_pages * self.page_len * cfg.n_kv_heads * cfg.head_dim
               * self.store_dtype.itemsize)
        return 2 * n_layers * per


def init_paged_cache(cfg: ModelConfig, spec: PageSpec,
                     device) -> List[dict]:
    """Per-segment page pools: ``(count, n_pages, page_len, kv, hd)``."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (spec.n_pages, spec.page_len, kv, hd)
    return [{"k": torch.zeros((s.count,) + shape, dtype=spec.store_dtype,
                              device=device),
             "v": torch.zeros((s.count,) + shape, dtype=spec.store_dtype,
                              device=device)}
            for s in attention_segments(cfg)]


def init_contig_cache(cfg: ModelConfig, spec: PageSpec,
                      device) -> List[dict]:
    """Contiguous baseline caches with the SAME logical extent as the
    paged pool (``slot_tokens`` per slot) — the bit-parity contract."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (spec.n_slots, spec.slot_tokens, kv, hd)
    return [{"k": torch.zeros((s.count,) + shape, dtype=spec.store_dtype,
                              device=device),
             "v": torch.zeros((s.count,) + shape, dtype=spec.store_dtype,
                              device=device)}
            for s in attention_segments(cfg)]


# ------------------------- shared attention math ---------------------------
def _slot_attention(q, k, v, positions, window: int):
    """Masked attention over per-row KV state — the ONE math path both
    backends feed.  q: (m, T, H, hd); k/v: (m, S, KV, hd); positions:
    (m, T) per-row absolute positions of the chunk tokens; window: the
    layer's window (0 = global)."""
    m, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    n_rep = h // kvh
    k = gqa_expand(k, n_rep).float()
    v = gqa_expand(v, n_rep).float()
    qf = q.float() * hd ** -0.5
    scores = torch.einsum("bqhd,bshd->bhqs", qf, k)
    idx = torch.arange(s, device=q.device)
    valid = idx[None, None, :] <= positions[:, :, None]           # (m, T, S)
    if window > 0:
        valid = torch.logical_and(
            valid, idx[None, None, :] > positions[:, :, None] - window)
    scores = torch.where(valid[:, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", p, v).to(q.dtype)


def _upload(a: np.ndarray, device, dtype=torch.int64) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


# ------------------------- the serve step ----------------------------------
def make_serve_step(cfg: ModelConfig, spec: PageSpec,
                    backend: str = "paged", *, gather_rows: bool = False):
    """Build the batched serve step for one backend.

    Returns ``step(params, caches, rows, lengths, active, tokens) ->
    (logits (m, T, V), caches)``, the caches updated in place, where the
    last four are host int32 numpy arrays:

      rows     paged:  (m, pages_per_slot) page-table rows
               contig: (m,) slot ids owning each batch row
      lengths  (m,) — tokens already in each row's cache; the chunk
               occupies positions lengths[i] .. lengths[i] + T - 1
      active   (m,) — per-row count of VALID chunk tokens: row i writes
               KV only for chunk positions j < active[i]
      tokens   (m, T)

    ``gather_rows`` (contig only): gather cache rows by slot id — needed
    when m < n_slots (single-row prefill).  With ``gather_rows=False`` the
    cache is read whole and ``rows`` MUST be ``arange(n_slots)``.
    """
    segs = attention_segments(cfg)
    if backend not in ("paged", "contig"):
        raise ValueError(f"backend must be 'paged' or 'contig': {backend!r}")
    paged = backend == "paged"
    page_len, pp = spec.page_len, spec.pages_per_slot
    n_pages, slot_tokens = spec.n_pages, spec.slot_tokens
    kvh, hd = cfg.n_kv_heads, cfg.head_dim

    def write_plan(rows, positions, active):
        """(source rows of the flattened (m*T) chunk, destination rows of
        the flattened cache) of every write that lands — the reference's
        ``mode="drop"`` scatter, decided on the host."""
        t = positions.shape[1]
        ok = np.arange(t)[None, :] < active[:, None]
        ok &= positions < slot_tokens
        if paged:
            pi = np.take_along_axis(
                rows, np.clip(positions // page_len, 0, pp - 1), axis=1)
            ok &= (pi >= 0) & (pi < n_pages)
            dst = pi.astype(np.int64) * page_len + positions % page_len
        else:
            slot = np.broadcast_to(rows[:, None], positions.shape)
            ok &= (slot >= 0) & (slot < spec.n_slots)
            dst = slot.astype(np.int64) * slot_tokens + positions
        src = np.flatnonzero(ok)
        return src, dst.reshape(-1)[src]

    def step(params, caches, rows, lengths, active, tokens):
        rows, lengths = np.asarray(rows, np.int32), np.asarray(lengths,
                                                              np.int32)
        active, tokens = np.asarray(active, np.int32), np.asarray(tokens,
                                                                 np.int32)
        m, t = tokens.shape
        dev = params["embed"].device
        cdt = dtype_of(cfg.compute_dtype)
        positions_np = lengths[:, None] + np.arange(t, dtype=np.int32)
        src, dst = write_plan(rows, positions_np, active)
        # the tick's inputs, copied to the card once
        tok_d = _upload(tokens, dev)
        positions = _upload(positions_np, dev, torch.int32)
        src_d, dst_d = _upload(src, dev), _upload(dst, dev)
        flash_tick = (paged and t == 1
                      and fd.resolve_impl("auto", dev) == "cuda")
        if paged:
            rows_read = _upload(np.clip(rows, 0, n_pages - 1), dev)
            if flash_tick:
                table_d = _upload(rows, dev, torch.int32)
                lengths_d = _upload(lengths, dev, torch.int32)
        elif gather_rows:
            rows_read = _upload(rows, dev)
        rope = rope_tables(positions, hd, cfg.rope_theta)

        def write_kv(ck, kk):
            flat_ck = ck.view(-1, kvh, hd)
            flat_ck.index_copy_(0, dst_d, kk.reshape(m * t, kvh, hd)
                                .index_select(0, src_d).to(ck.dtype))

        def read_kv(ck):
            if paged:
                return ck[rows_read].reshape(m, slot_tokens, kvh, hd)
            return ck[rows_read] if gather_rows else ck

        x = params["embed"][tok_d].to(cdt)
        for seg, sp, cache in zip(segs, params["segments"], caches):
            uniform_w = seg.windows[0] if len(set(seg.windows)) == 1 else None
            flash = flash_tick and uniform_w is not None
            for i in range(seg.count):
                attn = {k: w[i] for k, w in sp["attn"].items()}
                ck, cv = cache["k"][i], cache["v"][i]
                xin = rms_norm(x, sp["ln1"][i], cfg.norm_eps)
                q, k, v = attn_project_qkv(attn, xin, positions, cfg,
                                           rope=rope)
                write_kv(ck, k)
                write_kv(cv, v)
                if flash:
                    o = fd.flash_decode_paged(
                        q.transpose(1, 2), ck, cv, table_d, lengths_d,
                        window=uniform_w).transpose(1, 2)
                else:
                    o = _slot_attention(q, read_kv(ck), read_kv(cv),
                                        positions, seg.windows[i])
                h = x + o.reshape(m, t, cfg.n_heads * hd) @ attn["wo"]
                hin = rms_norm(h, sp["ln2"][i], cfg.norm_eps)
                if cfg.moe:
                    y, _ = moe_ffn({k: w[i] for k, w in sp["moe"].items()},
                                   hin, cfg.moe, dropless=True)
                else:
                    mlp = {k: w[i] for k, w in sp["mlp"].items()}
                    y = swiglu(hin, mlp["wi"], mlp["wg"], mlp["wo"])
                x = h + y

        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        head = params.get("lm_head", params["embed"])
        logits = torch.einsum("bsd,vd->bsv", x, head)
        return logits, caches

    return step


# ------------------------- token selection ---------------------------------
def sample_tokens(logits, key, scale, top_k: int, rids, steps0):
    """The sampled selection of ``make_token_fn``: ``(m, T)`` int32 tokens
    from ``(m, T, V)`` logits, every tensor on the logits' device.

    As the reference: the logits in f32; ``top_k > 0`` keeps those at or
    above the k-th largest of their row (ties at the k-th value stay) and
    sets the rest to ``NEG_INF``; ``scale`` (the f32 reciprocal of the
    temperature, a 0-d tensor: XLA compiles the reference's division by a
    constant temperature into that product) scales them; chunk position
    ``j`` of row ``i`` draws ``categorical`` over its own key
    ``fold_in(fold_in(key, rids[i]), steps0[i] + j)`` (``core.prng``).
    ``rids`` / ``steps0`` are ``(m,)`` integer tensors (int32 values,
    bit-cast as the reference's traced int32 are)."""
    lo = logits.float()
    if top_k > 0:
        kth = torch.topk(lo, top_k, dim=-1).values[..., -1:]
        lo = torch.where(lo >= kth, lo, NEG_INF)
    lo = lo * scale
    steps = steps0[:, None] + torch.arange(lo.shape[1], device=lo.device)
    keys = prng.fold_in(prng.fold_in(key, rids)[:, None], steps)
    return prng.categorical(keys, lo).to(torch.int32)


def make_token_fn(cfg: ModelConfig, spec: PageSpec, backend: str = "paged",
                  *, gather_rows: bool = False, temperature: float = 0.0,
                  top_k: int = 0, seed: int = 0):
    """Serve step + token selection on the device (one sync per tick).

    Returns ``fn(params, caches, rows, lengths, active, tokens, rids,
    steps0) -> (next_tokens (m, T) int32, logits (m, T, V), caches)``,
    both on the step's device; the caller pulls only ``next_tokens``.

    ``temperature == 0`` is greedy argmax (the first maximal index, as
    the reference's).  ``temperature > 0`` samples chunk position ``j``
    of row ``i`` with the reference's threefry key ``fold_in(fold_in(
    PRNGKey(seed), rids[i]), steps0[i] + j)`` (``sample_tokens``), keyed
    on (seed, request, generation step), so a sampled stream replays the
    same whatever the batch composition, slot bucketing or admission
    order.  The host arrays ``rids`` / ``steps0`` go to the device in one
    copy a tick, made before the step's forward is queued, as the step's
    own uploads are; the keys are derived there, no row a Python loop.
    """
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0: {temperature}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0: {top_k}")
    step = make_serve_step(cfg, spec, backend, gather_rows=gather_rows)
    consts = {}                      # device -> (PRNGKey(seed), 1 / T)

    def fn(params, caches, rows, lengths, active, tokens, rids, steps0):
        if temperature == 0.0:
            logits, caches = step(params, caches, rows, lengths, active,
                                  tokens)
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
            return toks, logits, caches
        dev = params["embed"].device
        if dev not in consts:
            recip = torch.ones((), dtype=torch.float32) / torch.tensor(
                temperature, dtype=torch.float32)
            consts[dev] = (prng.PRNGKey(seed, dev), recip.to(dev))
        # uploaded beside the step's own uploads, before its forward is
        # queued: a pageable copy waits for the stream to drain
        ids = _upload(np.stack([np.asarray(rids, np.int32),
                                np.asarray(steps0, np.int32)]), dev)
        logits, caches = step(params, caches, rows, lengths, active, tokens)
        toks = sample_tokens(logits, *consts[dev], top_k, ids[0], ids[1])
        return toks, logits, caches

    return fn


# ------------------------- copy-on-write page duplication ------------------
def make_cow_copy(cfg: ModelConfig):
    """Page duplication for copy-on-write prefix sharing.

    ``cow(caches, src, dst)`` copies page ``src`` onto page ``dst`` in
    every attention layer's K and V pools, in place, and returns the
    caches.  As the reference's scatter, a ``dst`` outside the pool is
    dropped and a ``src`` outside it reads the nearest page (the gather's
    clamp).
    """
    def cow(caches, src, dst):
        for c in caches:
            n_pages = c["k"].shape[1]
            d, s = int(dst), min(max(int(src), 0), n_pages - 1)
            if 0 <= d < n_pages:
                c["k"][:, d].copy_(c["k"][:, s])
                c["v"][:, d].copy_(c["v"][:, s])
        return caches
    return cow
