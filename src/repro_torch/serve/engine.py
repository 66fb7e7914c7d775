"""ServeEngine: the device half of the serving stack.

The scheduler (``serve.scheduler.run_serve_loop``) decides WHAT happens
each tick; this engine is the hook object that makes it happen on
device.  It owns the KV state (paged pool or contiguous baseline — both
built by ``serve.paged``) and the host-side mirrors the scheduler's
decisions key into (page-table rows, per-slot lengths, pending token,
token history).

One step family serves everything: decode is the ``(m, 1)`` shape,
chunked prefill the ``(1, C)`` shape, and the speculative verify chunk
the ``(m, k+1)`` shape.  ``compile_log`` keeps the reference's meaning —
the first-use order of ``(kind, m, T)`` — though PyTorch compiles
nothing: steady-state serving stops adding entries after the first few
ticks (speculation adds at most ONE extra ``T`` value, ``spec_k + 1``,
because every verify tick shares the same padded width).  Each step
updates the KV pool in place.  On the card a one-token decode tick of the
paged backend runs the hand-written paged decode kernel in every layer
(``kernels.flash_decode.flash_decode_paged``).

Speculative decode (``spec_k > 0``, greedy-only) is draft-model-free:
per-slot n-gram prompt lookup (``serve.draft``) proposes up to ``k``
tokens from the slot's own history; ONE batched ``(m, k+1)`` verify
step scores the pending token plus every draft; the longest
greedy-matching draft prefix is accepted, emitting ``a + 1`` tokens for
one dispatch.  Rejection is pure bookkeeping — the slot's length simply
doesn't advance past the accepted prefix, and the junk KV the verify
step wrote beyond it is overwritten by the next chunk before any query
can attend to it (see ``serve.paged``).  Greedy acceptance makes the
emitted stream token-identical to one-token decode (tested, as the
paged-vs-contig parity is).

Sampling (``temperature > 0``, ``top_k``) runs inside the step
(``paged.make_token_fn``): each token is drawn with the reference's
threefry key ``fold_in(fold_in(PRNGKey(sample_seed), rid), step)``
(``core.prng``), so a request's sampled stream is the same whatever the
batch it rides in, and equals the reference's token for token outside
f32 near-ties.  Speculation fences to greedy-only (drafting against a
sampled stream would break the identity contract), loudly, as the
reference's does.

``fused_sample=False`` keeps the reference's baseline: logits come back
from the step and argmax runs as a separate call per tick.  The fused
path picks the tokens inside the step and syncs ONE int32 token row per
tick.

Prefix sharing (``prefix_share=True``, paged only): admission maps
already-resident pages of a matching prompt prefix into the new slot's
table (refcount +1, no data movement), skips their prefill chunks, and
duplicates a partially-matched boundary page copy-on-write before the
slot's first write into it (``paged.make_cow_copy`` — one dispatch).

Per-request latency is recorded as wall-clock ``ServeRecord``s: TTFT
(admission → first sampled token) and per-token timestamps.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves
from repro_torch.device import resolve_device, strict_f32
from repro_torch.serve import paged as pg
from repro_torch.serve.draft import accepted_prefix_len, propose_ngram
from repro_torch.serve.scheduler import PagePool, Request, run_serve_loop


@dataclass
class ServeRecord:
    """Per-request outcome + latency trace (wall-clock seconds)."""
    rid: int
    prompt_len: int
    max_new: int
    slot: int = -1
    pages: Tuple[int, ...] = ()
    skipped: int = 0                      # prefill tokens shared, not run
    tokens: List[int] = field(default_factory=list)
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    token_times: List[float] = field(default_factory=list)
    logits: List[np.ndarray] = field(default_factory=list)

    @property
    def ttft_s(self) -> float:
        """Admission -> first token (prefill latency the request saw)."""
        return self.t_first - self.t_admit

    @property
    def tpot_s(self) -> float:
        """Mean inter-token time after the first."""
        if len(self.token_times) < 2:
            return 0.0
        gaps = np.diff(np.asarray(self.token_times))
        return float(np.mean(gaps))


class ServeEngine:
    """Continuous-batching (or static) serving over one model.

    ``backend="paged"`` runs on the page pool; ``backend="contig"`` is
    the contiguous-cache baseline with identical logical extents — the
    two produce bit-identical f32 logits on the plain path (see
    ``serve.paged``).  ``device=None`` means the card; the params must
    live on the engine's device.  On CUDA, building an engine turns TF32
    off process-wide (``device.strict_f32``): the attention math is f32,
    as the reference's.
    """

    def __init__(self, cfg, params, *, spec: Optional[pg.PageSpec] = None,
                 backend: str = "paged", prefill_chunk: int = 16,
                 slot_buckets: Optional[bool] = None,
                 eos_id: Optional[int] = None, record_logits: bool = False,
                 spec_k: int = 0, draft_ngram: int = 3,
                 draft_fn: Optional[Callable] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0, prefix_share: bool = False,
                 fused_sample: bool = True, device=None):
        pg.attention_segments(cfg)            # servable arch or raise
        if backend not in ("paged", "contig"):
            raise ValueError(f"backend must be 'paged' or 'contig': {backend!r}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0: {spec_k}")
        if spec_k > 0 and temperature > 0.0:
            raise ValueError(
                "speculative drafting is greedy-only: acceptance compares "
                "drafts against the argmax stream, so temperature > 0 would "
                "break the token-identity contract — run spec_k=0 when "
                "sampling (or temperature=0.0 to speculate)")
        if temperature > 0.0 and not fused_sample:
            raise ValueError(
                "temperature sampling needs the in-step RNG streams; "
                "fused_sample=False is the greedy host-argmax baseline")
        if prefix_share and backend != "paged":
            raise ValueError(
                "prefix_share needs the page-table indirection (refcounted "
                "pages, COW duplication); the contiguous baseline has none")
        self.device = resolve_device(device)
        for leaf in tree_leaves(params):
            if leaf.device != self.device:
                raise ValueError(f"params live on {leaf.device} but the "
                                 f"engine runs on {self.device}")
        strict_f32(self.device)
        self.cfg, self.params = cfg, params
        self.spec = spec if spec is not None else pg.PageSpec()
        self.backend = backend
        self.prefill_chunk = int(prefill_chunk)
        if slot_buckets is None:
            slot_buckets = backend == "paged"
        if slot_buckets and backend == "contig":
            raise ValueError("slot_buckets needs the page-table indirection; "
                             "contiguous cache rows ARE the slots")
        self.slot_buckets = bool(slot_buckets)
        self.eos_id = eos_id
        self.record_logits = bool(record_logits)
        self.spec_k = int(spec_k)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.prefix_share = bool(prefix_share)
        self.fused_sample = bool(fused_sample)
        self._draft = draft_fn if draft_fn is not None else (
            lambda hist, n: propose_ngram(hist, n, max_ngram=draft_ngram))

        sample = dict(temperature=temperature, top_k=top_k, seed=sample_seed)
        if fused_sample:
            if backend == "paged":
                self._tok_fn = pg.make_token_fn(cfg, self.spec, "paged",
                                                **sample)
                self._row_tok_fn = self._tok_fn    # paged handles any m
            else:
                self._tok_fn = pg.make_token_fn(cfg, self.spec, "contig",
                                                gather_rows=False, **sample)
                self._row_tok_fn = pg.make_token_fn(
                    cfg, self.spec, "contig", gather_rows=True, **sample)
        else:
            if backend == "paged":
                self._step_fn = pg.make_serve_step(cfg, self.spec, "paged")
                self._row_fn = self._step_fn
            else:
                self._step_fn = pg.make_serve_step(cfg, self.spec, "contig",
                                                   gather_rows=False)
                self._row_fn = pg.make_serve_step(cfg, self.spec, "contig",
                                                  gather_rows=True)
        self._cow_fn = (pg.make_cow_copy(cfg) if backend == "paged"
                        else None)
        self.compile_log: List[tuple] = []     # (kind, m, T) first-use order
        self._seen: set = set()
        self.log: List[tuple] = []
        self.wall_s = 0.0
        self._reset()

    # ------------------------------------------------------------------
    def _reset(self) -> None:
        spec, cfg = self.spec, self.cfg
        self._caches = None                   # free the old pool first
        self._caches = (pg.init_paged_cache(cfg, spec, self.device)
                        if self.backend == "paged"
                        else pg.init_contig_cache(cfg, spec, self.device))
        # sentinel: unowned table entries point one past the pool, so any
        # stray write drops instead of corrupting page 0 (reads clamp)
        self._table = np.full((spec.n_slots, spec.pages_per_slot),
                              spec.n_pages, np.int32)
        self._lengths = np.zeros((spec.n_slots,), np.int32)
        self._tok = np.zeros((spec.n_slots,), np.int32)
        self._alloc = np.zeros((spec.n_slots,), np.int32)
        self._hist: Dict[int, List[int]] = {}
        self._slot_rid: Dict[int, int] = {}
        self.records: Dict[int, ServeRecord] = {}
        self.stats = {"prefill_calls": 0, "decode_calls": 0, "decode_rows": 0,
                      "spec_dispatches": 0, "draft_proposed": 0,
                      "draft_accepted": 0, "prompt_tokens": 0,
                      "prefill_skipped_tokens": 0, "cow_copies": 0}

    def _call(self, kind: str, rows, lengths, active, tokens, rids, steps0):
        """One model step; returns (host int32 tokens (m, T), device
        logits).  Fused: selection runs in the step, ONE sync pulls the
        token row.  Legacy: a separate argmax call + sync per call."""
        key = (kind, tokens.shape[0], tokens.shape[1])
        if key not in self._seen:
            self._seen.add(key)
            self.compile_log.append(key)
        if self.fused_sample:
            fn = self._row_tok_fn if kind == "rows" else self._tok_fn
            toks, logits, self._caches = fn(
                self.params, self._caches, rows, lengths, active, tokens,
                rids, steps0)
            return toks.cpu().numpy(), logits
        fn = self._row_fn if kind == "rows" else self._step_fn
        logits, self._caches = fn(self.params, self._caches, rows,
                                  lengths, active, tokens)
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy(), \
            logits

    # ------------------------ scheduler hooks -------------------------
    def admit(self, slot: int, req: Request, pages: Tuple[int, ...], *,
              shared: Tuple[int, ...] = (), start: int = 0,
              cow=None) -> None:
        self._table[slot] = self.spec.n_pages
        self._table[slot, :len(pages)] = pages
        self._lengths[slot] = start           # shared KV already resident
        self._tok[slot] = 0
        self._alloc[slot] = len(pages) * self.spec.page_len
        self._hist[slot] = list(req.tokens)
        self._slot_rid[slot] = req.rid
        self.stats["prompt_tokens"] += len(req.tokens)
        self.stats["prefill_skipped_tokens"] += start
        self.records[req.rid] = ServeRecord(
            rid=req.rid, prompt_len=len(req.tokens), max_new=req.max_new,
            slot=slot, pages=tuple(pages), skipped=start,
            t_admit=time.perf_counter())

    def cow(self, slot: int, req: Request, src: int, dst: int) -> None:
        """Duplicate shared boundary page src -> dst before first write."""
        self._caches = self._cow_fn(self._caches, src, dst)
        row = self._table[slot]
        row[row == src] = dst
        self.stats["cow_copies"] += 1

    def prefill(self, slot: int, req: Request, chunk: Sequence[int],
                pos: int, last: bool) -> None:
        c = self.prefill_chunk
        toks = np.zeros((1, c), np.int32)
        toks[0, :len(chunk)] = chunk           # pad tail: never written,
        if self.backend == "paged":            # junk logits discarded
            rows, kind = self._table[slot:slot + 1], "step"
        else:
            rows, kind = np.asarray([slot], np.int32), "rows"
        # the last real position samples generation step 0 of this request
        sampled, logits = self._call(
            kind, rows, np.asarray([pos], np.int32),
            np.asarray([len(chunk)], np.int32), toks,
            np.asarray([req.rid], np.int32),
            np.asarray([1 - len(chunk)], np.int32))
        self._lengths[slot] = pos + len(chunk)
        self.stats["prefill_calls"] += 1
        if last:
            tok = int(sampled[0, len(chunk) - 1])
            now = time.perf_counter()
            rec = self.records[req.rid]
            rec.t_first = now
            rec.tokens.append(tok)
            rec.token_times.append(now)
            if self.record_logits:
                rec.logits.append(
                    logits[0, len(chunk) - 1].float().cpu().numpy())
            self._tok[slot] = tok
            self._hist[slot].append(tok)

    def decode(self, slots: Tuple[int, ...]) -> Dict[int, int]:
        spec = self.spec
        # -- draft: propose up to k tokens per slot (host-side lookup) --
        drafts: Dict[int, List[int]] = {}
        if self.spec_k > 0:
            for slot in slots:
                rec = self.records[self._slot_rid[slot]]
                room = min(rec.max_new - len(rec.tokens) - 1,
                           int(self._alloc[slot]) - int(self._lengths[slot])
                           - 1, self.spec_k)
                d = self._draft(self._hist[slot], room) if room > 0 else []
                drafts[slot] = [int(t) for t in d][:max(0, room)]
        # shared verify width: ONE extra compile-cache T value, ever
        t_dim = self.spec_k + 1 if any(drafts.values()) else 1

        if self.slot_buckets:
            m = 1
            while m < len(slots):
                m <<= 1
            m = min(m, spec.n_slots)
            rowmap = list(enumerate(slots))    # (row, slot): compacted
            rows = np.full((m, spec.pages_per_slot), spec.n_pages, np.int32)
        else:
            rowmap = [(s, s) for s in slots]   # rows ARE slots
            m = spec.n_slots
            rows = (self._table.copy() if self.backend == "paged"
                    else np.arange(spec.n_slots, dtype=np.int32))
        lengths = np.zeros((m,), np.int32)
        active = np.zeros((m,), np.int32)
        toks = np.zeros((m, t_dim), np.int32)
        rids = np.zeros((m,), np.int32)
        steps0 = np.zeros((m,), np.int32)
        for row, slot in rowmap:
            if self.slot_buckets:
                rows[row] = self._table[slot]
            d = drafts.get(slot, [])
            toks[row, 0] = self._tok[slot]
            toks[row, 1:1 + len(d)] = d
            active[row] = 1 + len(d)
            lengths[row] = self._lengths[slot]
            rids[row] = self._slot_rid[slot]
            steps0[row] = len(self.records[self._slot_rid[slot]].tokens)
        sampled, logits = self._call("step", rows, lengths, active, toks,
                                     rids, steps0)

        # -- accept: longest greedy-matching draft prefix per slot ------
        now = time.perf_counter()
        counts: Dict[int, int] = {}
        for row, slot in rowmap:
            d = drafts.get(slot, [])
            verified = [int(t) for t in sampled[row, :len(d) + 1]]
            a = accepted_prefix_len(d, verified)
            emitted = verified[:a + 1]
            if self.eos_id is not None and self.eos_id in emitted:
                emitted = emitted[:emitted.index(self.eos_id) + 1]
            e = len(emitted)
            rec = self.records[self._slot_rid[slot]]
            self._lengths[slot] += e          # rollback = not advancing
            self._tok[slot] = emitted[-1]
            self._hist[slot].extend(emitted)
            rec.tokens.extend(emitted)
            rec.token_times.extend([now] * e)
            if self.record_logits:
                lg = logits[row, :e].float().cpu().numpy()
                for j in range(e):
                    rec.logits.append(lg[j])
            counts[slot] = e
            if d:
                self.stats["draft_proposed"] += len(d)
                self.stats["draft_accepted"] += a
        self.stats["decode_calls"] += 1
        self.stats["decode_rows"] += m
        if t_dim > 1:
            self.stats["spec_dispatches"] += 1
        return counts

    def evict(self, slot: int, req: Request) -> None:
        rec = self.records[req.rid]
        rec.t_done = time.perf_counter()
        self._table[slot] = self.spec.n_pages
        self._slot_rid.pop(slot, None)
        self._hist.pop(slot, None)

    def finished(self, slot: int, req: Request) -> bool:
        if self.eos_id is None:
            return False
        rec = self.records[req.rid]
        return bool(rec.tokens) and rec.tokens[-1] == self.eos_id

    # ------------------------------------------------------------------
    @property
    def accept_rate(self) -> float:
        """Fraction of proposed draft tokens the verify step accepted."""
        p = self.stats["draft_proposed"]
        return self.stats["draft_accepted"] / p if p else 0.0

    @property
    def prefill_skip_frac(self) -> float:
        """Fraction of prompt tokens admitted straight from shared pages."""
        p = self.stats["prompt_tokens"]
        return self.stats["prefill_skipped_tokens"] / p if p else 0.0

    def serve(self, requests: Sequence[Request], *,
              policy: str = "continuous",
              static_batch: Optional[int] = None) -> List[ServeRecord]:
        """Run every request to completion; returns records sorted by rid.

        ``compile_log`` persists across calls; KV state and latency
        records reset per call.
        """
        self._reset()
        pool = PagePool(self.spec.n_pages)
        t0 = time.perf_counter()
        self.log = run_serve_loop(
            requests, self.spec, self, prefill_chunk=self.prefill_chunk,
            policy=policy, static_batch=static_batch, pool=pool,
            prefix_share=self.prefix_share)
        self.wall_s = time.perf_counter() - t0
        return [self.records[r.rid]
                for r in sorted(requests, key=lambda r: r.rid)]

    def generated_tokens(self) -> int:
        return sum(len(r.tokens) for r in self.records.values())
