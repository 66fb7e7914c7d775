"""Continuous-batching slot scheduler: a host-side, hook-driven serve loop.

Same shape as the cluster simulator's event loop
(``cluster.simulator.run_event_loop``): the schedule itself is a pure
host-side pass — admission, slot assignment, page-budget accounting,
prefill/decode interleaving, eviction — while all device work hides
behind caller-supplied hooks.  Because the timeline never depends on
*which* tokens the model produces (absent an early-``finished`` signal
or a speculative decode hook reporting multi-token ticks), the whole
schedule is deterministic given the request list, and can be tested
with stub hooks that never touch a device.

One *tick* is the scheduling quantum: admit what fits, run at most one
chunked-prefill call (the large-batch, compute-bound regime), then one
batched decode call over every in-flight slot (the small-batch,
latency-bound regime).  That interleaving is the serving-side mirror of
the paper's dual-batch insight — two batch regimes sharing one run,
trading aggregate throughput against per-request latency.

Policies:

  ``continuous``  admit head-of-line requests the moment a slot AND the
                  page budget allow — new requests join mid-flight.
  ``static``      the classic baseline: admit a full batch only when the
                  previous batch has fully drained (and hold admission
                  until ``static_batch`` requests have arrived, unless no
                  more ever will).

``PagePool`` is the accounting half of the paged KV cache: a free list
of physical page ids, LIFO reuse (so re-admitted requests land on
maximally scrambled pages — exactly what the paged-vs-contiguous parity
tests want to stress), per-page REFCOUNTS so prefix sharing can map one
physical page into several slots' tables, and loud failure on leaks /
double-frees / over-allocation / ref-drops of unheld pages.

``PrefixRegistry`` + ``prefix_share=True`` turn admission into prefix
reuse: each fully-prefilled page is registered under the *token prefix
preceding it* (content-keyed, so identity is positional AND textual); a
new request maps the longest matching page chain straight into its
table, skips those prefill chunks entirely, and — when it also matches
part of a boundary page — duplicates that one page copy-on-write before
its first write into it.  Registry entries live exactly as long as the
physical page (dropped when the refcount hits zero), so sharing only
ever binds to resident, fully-written KV.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.paged import PageSpec


@dataclass(frozen=True)
class Request:
    """One serving request: a prompt, a generation budget, an arrival tick."""
    rid: int
    tokens: Tuple[int, ...]
    max_new: int
    arrival: int = 0

    def __post_init__(self):
        object.__setattr__(self, "tokens", tuple(int(t) for t in self.tokens))
        if not self.tokens:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new < 1:
            raise ValueError(f"request {self.rid}: max_new must be >= 1")


class PagePool:
    """Physical-page allocator for the paged KV cache, with refcounts.

    Pages are ids into the pool's leading axis.  ``alloc`` hands out
    exclusive pages (refcount 1); ``share`` maps already-live pages into
    another holder's set (refcount +1); ``release`` drops one page from
    one holder (copy-on-write's "stop reading the shared original");
    ``free`` drops a holder entirely.  A page returns to the free list
    only when its refcount reaches zero.  The free list is LIFO:
    freshly freed pages are handed out first, so slots that churn end up
    with physically scrambled, non-contiguous page sets.  Every
    inconsistency raises — double-ALLOC, double-FREE (a holder freeing
    twice) and bad REF-DROPS (releasing a page the holder doesn't have)
    are distinct failures, and the property tests drive random
    alloc/share/release/free interleavings through ``audit``.
    """

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError("pool needs at least one page")
        self.n_pages = int(n_pages)
        self._free: List[int] = list(range(self.n_pages))
        self._held: Dict[Any, List[int]] = {}
        self._ref: List[int] = [0] * self.n_pages

    @property
    def n_free(self) -> int:
        return len(self._free)

    def holds(self, rid) -> Tuple[int, ...]:
        return tuple(self._held.get(rid, ()))

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def can_alloc(self, n: int) -> bool:
        return 0 < n <= len(self._free)

    def alloc(self, rid, n: int) -> Tuple[int, ...]:
        if rid in self._held:
            raise ValueError(f"request {rid} already holds pages")
        if n < 1:
            raise ValueError(f"request {rid}: must allocate >= 1 page")
        if n > len(self._free):
            raise ValueError(
                f"request {rid}: wants {n} pages, pool has {len(self._free)}")
        pages = tuple(self._free[:n])
        del self._free[:n]
        for p in pages:
            self._ref[p] = 1
        self._held[rid] = list(pages)
        return pages

    def share(self, rid, pages: Sequence[int]) -> None:
        """Map live pages into ``rid``'s holdings (refcount +1 each)."""
        held = self._held.setdefault(rid, [])
        for p in pages:
            if self._ref[p] < 1:
                raise ValueError(f"request {rid}: sharing free page {p}")
            if p in held:
                raise ValueError(f"request {rid} already holds page {p}")
        for p in pages:
            self._ref[p] += 1
            held.append(p)

    def release(self, rid, page: int) -> bool:
        """Drop ONE page from ``rid``'s holdings (the COW ref-drop).

        Returns True when the page's refcount hit zero and it went back
        to the free list.  Releasing a page ``rid`` doesn't hold raises
        — a ref-drop bug, distinct from the double-free of ``free``.
        """
        held = self._held.get(rid)
        if held is None or page not in held:
            raise KeyError(
                f"request {rid} does not hold page {page} (bad ref-drop)")
        held.remove(page)
        if not held:
            del self._held[rid]
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.insert(0, page)     # LIFO: churn scrambles placement
            return True
        return False

    def free(self, rid) -> Tuple[int, ...]:
        """Drop every page ``rid`` holds; returns the pages whose refcount
        hit zero (actually returned to the pool — shared pages another
        holder still maps stay resident)."""
        if rid not in self._held:
            raise KeyError(f"request {rid} holds no pages (double free?)")
        pages = self._held.pop(rid)
        freed = []
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                freed.append(p)
        self._free[:0] = freed            # LIFO: churn scrambles placement
        return tuple(freed)

    def audit(self) -> None:
        """Raise unless refcounts, holdings and the free list agree:
        every page is free exactly-once XOR held by exactly ``refcount``
        distinct holders, and no holder lists a page twice."""
        counts = [0] * self.n_pages
        for rid, pages in self._held.items():
            if len(pages) != len(set(pages)):
                raise AssertionError(f"holder {rid} lists a page twice: "
                                     f"{sorted(pages)}")
            for p in pages:
                counts[p] += 1
        if sorted(self._free) != sorted(set(self._free)):
            raise AssertionError(f"free list has duplicates: {self._free}")
        for p in range(self.n_pages):
            in_free = p in set(self._free)
            if counts[p] != self._ref[p] or (self._ref[p] == 0) != in_free:
                raise AssertionError(
                    f"page {p} accounting broken: ref={self._ref[p]} "
                    f"holders={counts[p]} free={in_free}")


class PrefixRegistry:
    """Content-keyed map from token prefixes to resident KV pages.

    ``next[prefix]`` holds CANDIDATE continuations — ``(page_id,
    page_tokens)`` pairs, one per registered physical page whose KV
    covers the tokens that FOLLOW ``prefix`` (up to ``page_len`` of
    them).  Divergent continuations of the same prefix coexist (the
    flat-dict rendering of a radix tree's children), so a popular system
    prompt with many different user suffixes keeps every live suffix
    matchable.  Matching walks page by page: a candidate matching its
    full ``page_len`` tokens extends the shared chain; the best partial
    match (divergence mid-page, or a partially-filled boundary page)
    yields a COW candidate.  Entries are content-addressed — identical
    prompts share by construction — and live exactly as long as their
    physical page (``drop_page`` on refcount zero), so a match always
    binds to resident, fully-written KV.
    """

    def __init__(self, page_len: int):
        self.page_len = int(page_len)
        self.next: Dict[Tuple[int, ...],
                        List[Tuple[int, Tuple[int, ...]]]] = {}
        self._by_page: Dict[int, List[Tuple[int, ...]]] = {}

    def register(self, prefix: Sequence[int], page_tokens: Sequence[int],
                 page_id: int) -> None:
        if not page_tokens or len(page_tokens) > self.page_len:
            raise ValueError(f"page_tokens must hold 1..{self.page_len} "
                             f"tokens, got {len(page_tokens)}")
        key, toks = tuple(prefix), tuple(page_tokens)
        cands = self.next.setdefault(key, [])
        for i, (pid, prev) in enumerate(cands):
            if pid == page_id:
                if len(toks) > len(prev):   # same page, longer extent
                    cands[i] = (pid, toks)
                return
        # content-identical candidates on DIFFERENT pages coexist: each
        # copy dies with its own page, so the duplicates are what keeps
        # a popular tail matchable across its writers' evictions
        cands.append((page_id, toks))
        self._by_page.setdefault(page_id, []).append(key)

    def drop_page(self, page_id: int) -> None:
        """Forget a page the pool just reclaimed (refcount hit zero)."""
        for key in self._by_page.pop(page_id, ()):
            cands = self.next.get(key)
            if cands is None:
                continue
            cands[:] = [c for c in cands if c[0] != page_id]
            if not cands:
                del self.next[key]

    def match(self, tokens: Sequence[int], max_match: int):
        """Longest registered prefix of ``tokens`` usable for sharing.

        Returns ``(full_pages, boundary, matched)``: the page ids whose
        full ``page_len`` tokens match, an optional ``(page_id,
        n_tokens)`` boundary page matching only its first ``n_tokens``
        (COW candidate), and the total matched token count
        (``<= max_match`` — callers cap at ``len(prompt) - 1`` so at
        least one prefill token always remains to sample from).
        Candidate ties break on insertion order: deterministic.
        """
        toks = tuple(tokens)
        full: List[int] = []
        pos = 0
        while pos < max_match:
            best_b, best_pid, best_len = 0, -1, 0
            for pid, ptoks in self.next.get(toks[:pos], ()):
                lim = min(max_match - pos, len(ptoks))
                b = 0
                while b < lim and ptoks[b] == toks[pos + b]:
                    b += 1
                if b > best_b:
                    best_b, best_pid, best_len = b, pid, len(ptoks)
            if best_b == best_len == self.page_len:
                full.append(best_pid)       # whole page matched: walk on
                pos += self.page_len
                continue
            if best_b > 0:
                return full, (best_pid, best_b), pos + best_b
            break
        return full, None, pos


@dataclass
class _Slot:
    req: Request
    pages: Tuple[int, ...]
    prefilled: int = 0
    generated: int = 0
    state: str = "prefill"               # "prefill" -> "decode"
    cow: Optional[Tuple[int, int]] = None  # (shared boundary pid, own copy)
    reg_upto: int = 0                    # full pages registered so far
    shared: Tuple[int, ...] = field(default_factory=tuple)


def run_serve_loop(requests: Sequence[Request], spec: PageSpec, hooks, *,
                   prefill_chunk: int = 16, policy: str = "continuous",
                   static_batch: Optional[int] = None,
                   pool: Optional[PagePool] = None,
                   prefix_share: bool = False,
                   max_ticks: int = 100_000) -> List[tuple]:
    """Drive every request to completion; return the schedule log.

    ``hooks`` supplies the device half (all optional except ``decode``
    in spirit — stubs are fine, the loop never inspects return values
    except ``finished`` and ``decode``'s optional per-slot counts):

      admit(slot, req, pages, shared=, start=, cow=)
                                              slot bound, table row built;
                                              ``shared`` pages are mapped
                                              (not owned), prefill resumes
                                              at token ``start``, ``cow``
                                              is (shared_pid, own_copy)
                                              when a boundary page must be
                                              duplicated before writing
      cow(slot, req, src, dst)                duplicate page src -> dst
                                              (before the slot's first
                                              prefill write; optional)
      prefill(slot, req, chunk, pos, last)    one (1, C) chunk; ``chunk``
                                              is the REAL token list (the
                                              engine pads to C); on
                                              ``last`` the first new
                                              token is sampled
      decode(slots) -> None | {slot: n}       one batched step over every
                                              in-flight slot; returning a
                                              per-slot emitted-token count
                                              (speculative decode) credits
                                              n tokens this tick, else 1
      evict(slot, req)                        done — before pages return
      finished(slot, req) -> bool             early stop (EOS); absent or
                                              False keeps length-only
                                              semantics (deterministic
                                              timeline)

    ``prefix_share=True`` adds registry-driven admission: a request whose
    prompt extends an already-resident, fully-prefilled page chain maps
    those pages (refcount +1), skips their prefill chunks, and — when it
    also matches part of a boundary page — gets a ``cow`` event before
    its first own write.  The COW copy's destination page is RESERVED at
    admission (it is just the slot's own page for that table index), so
    a COW can never fail mid-flight on an exhausted pool; admission
    simply waits until the non-shared page count fits.

    The log is a list of tuples — ``("admit", tick, rid, slot, pages,
    start)``, ``("cow", tick, rid, slot, src, dst)``, ``("prefill",
    tick, rid, slot, pos, n, last)``, ``("decode", tick, slots,
    counts)``, ``("evict", tick, rid, slot)`` — and is the determinism
    test's subject: same requests, same spec ⇒ same log, bit for bit.
    """
    if policy not in ("continuous", "static"):
        raise ValueError(f"unknown policy {policy!r}")
    pool = pool if pool is not None else PagePool(spec.n_pages)
    registry = PrefixRegistry(spec.page_len) if prefix_share else None
    batch_n = static_batch or spec.n_slots
    for r in requests:
        need = spec.pages_needed(len(r.tokens), r.max_new, prefill_chunk)
        if need > spec.pages_per_slot:
            raise ValueError(
                f"request {r.rid}: needs {need} pages "
                f"(prompt {len(r.tokens)} + {r.max_new} new @ chunk "
                f"{prefill_chunk}) > pages_per_slot={spec.pages_per_slot}")

    pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
    queue: List[Request] = []
    slots: List[Optional[_Slot]] = [None] * spec.n_slots
    log: List[tuple] = []
    finished_hook = getattr(hooks, "finished", None)
    cow_hook = getattr(hooks, "cow", None)
    tick = 0

    def _plan(req: Request):
        """(total pages, own-page count, shared full pages, boundary,
        matched tokens) for admitting ``req`` under the registry now."""
        total = spec.pages_needed(len(req.tokens), req.max_new,
                                  prefill_chunk)
        if registry is None:
            return total, total, [], None, 0
        full, boundary, matched = registry.match(req.tokens,
                                                 len(req.tokens) - 1)
        # own pages cover every table index past the full-shared chain —
        # including the boundary index, whose own page is the COW reserve
        return total, total - len(full), full, boundary, matched

    def _admit(req: Request) -> None:
        slot = next(i for i, s in enumerate(slots) if s is None)
        total, n_own, full, boundary, start = _plan(req)
        # the match cap (len - 1) guarantees at least one real prefill
        # token, so the last chunk is never empty and its final-position
        # logits always come from freshly written KV
        assert start < len(req.tokens), \
            f"rid {req.rid}: matched {start} >= prompt {len(req.tokens)}"
        own = pool.alloc(req.rid, n_own)
        cow = None
        shared = tuple(full)
        if boundary is not None:
            pid_b, _ = boundary
            cow = (pid_b, own[0])
            shared = shared + (pid_b,)
            pages = tuple(full) + (pid_b,) + tuple(own[1:])
        else:
            pages = tuple(full) + tuple(own)
        if shared:
            pool.share(req.rid, shared)
        slots[slot] = _Slot(req, pages, prefilled=start, cow=cow,
                            reg_upto=len(full), shared=shared)
        hooks.admit(slot, req, pages, shared=shared, start=start, cow=cow)
        log.append(("admit", tick, req.rid, slot, pages, start))

    def _register(s: _Slot, last: bool) -> None:
        """Publish ``s``'s freshly prefilled pages to the registry."""
        if registry is None:
            return
        toks, pl = s.req.tokens, spec.page_len
        p = len(toks)
        while (s.reg_upto + 1) * pl <= min(s.prefilled, p):
            j = s.reg_upto
            registry.register(toks[:j * pl], toks[j * pl:(j + 1) * pl],
                              s.pages[j])
            s.reg_upto = j + 1
        if last and p % pl and p // pl < len(s.pages):
            registry.register(toks[:(p // pl) * pl], toks[(p // pl) * pl:],
                              s.pages[p // pl])

    while pending or queue or any(s is not None for s in slots):
        if tick >= max_ticks:
            raise RuntimeError(f"serve loop exceeded {max_ticks} ticks")

        while pending and pending[0].arrival <= tick:
            queue.append(pending.pop(0))

        # -- admission ---------------------------------------------------
        if policy == "continuous":
            # head-of-line FCFS: never skip past a request that doesn't
            # fit — determinism and no starvation of large requests
            while queue and any(s is None for s in slots):
                if not pool.can_alloc(_plan(queue[0])[1]):
                    break
                _admit(queue.pop(0))
        else:
            # static: wait for the previous batch to fully drain, then
            # for a full batch (unless no more requests will ever arrive)
            if all(s is None for s in slots) and queue and (
                    len(queue) >= batch_n or not pending):
                for _ in range(min(batch_n, len(queue), spec.n_slots)):
                    _admit(queue.pop(0))

        # -- one chunked-prefill call (large-batch regime) ---------------
        for slot, s in enumerate(slots):
            if s is None or s.state != "prefill":
                continue
            if s.cow is not None:
                # duplicate the shared boundary page before the first
                # write into it; drop our ref on the original
                src, dst = s.cow
                if cow_hook is not None:
                    cow_hook(slot, s.req, src, dst)
                if pool.release(s.req.rid, src) and registry is not None:
                    registry.drop_page(src)
                s.pages = tuple(dst if p == src else p for p in s.pages)
                s.shared = tuple(p for p in s.shared if p != src)
                s.cow = None
                log.append(("cow", tick, s.req.rid, slot, src, dst))
            chunk = list(s.req.tokens[s.prefilled:s.prefilled + prefill_chunk])
            pos = s.prefilled
            s.prefilled += len(chunk)
            last = s.prefilled >= len(s.req.tokens)
            hooks.prefill(slot, s.req, chunk, pos, last)
            log.append(("prefill", tick, s.req.rid, slot, pos,
                        len(chunk), last))
            _register(s, last)
            if last:
                s.state = "decode"
                s.generated = 1          # sampled from the prefill logits
            break                        # at most one prefill per tick

        # -- one batched decode call (small-batch regime) ----------------
        live = tuple(i for i, s in enumerate(slots)
                     if s is not None and s.state == "decode"
                     and s.generated < s.req.max_new)
        if live:
            ret = hooks.decode(live)
            counts = tuple(1 for _ in live) if ret is None else \
                tuple(int(ret[i]) for i in live)
            for i, n in zip(live, counts):
                s = slots[i]
                if n < 1 or s.generated + n > s.req.max_new:
                    raise RuntimeError(
                        f"decode hook credited {n} tokens to slot {i} "
                        f"({s.generated}/{s.req.max_new} generated)")
                s.generated += n
            log.append(("decode", tick, live, counts))

        # -- completion / eviction ---------------------------------------
        for slot, s in enumerate(slots):
            if s is None or s.state != "decode":
                continue
            done = s.generated >= s.req.max_new
            if not done and finished_hook is not None and slot in live:
                done = bool(finished_hook(slot, s.req))
            if done:
                hooks.evict(slot, s.req)
                for p in pool.free(s.req.rid):
                    if registry is not None:
                        registry.drop_page(p)
                slots[slot] = None
                log.append(("evict", tick, s.req.rid, slot))
        tick += 1

    pool.audit()
    return log


def synthetic_workload(seed: int, n_requests: int, *, vocab: int = 512,
                       prompt_lens: Tuple[int, int] = (4, 24),
                       gen_short: Tuple[int, int] = (4, 10),
                       gen_long: Tuple[int, int] = (32, 48),
                       p_long: float = 0.2,
                       arrival_rate: float = 0.5) -> List[Request]:
    """Mixed-length Poisson workload (deterministic in ``seed``).

    Generation lengths are a heavy-tailed mixture — mostly short, a
    ``p_long`` fraction long — which is precisely the regime where static
    batching pays ``max(gen)`` per batch while continuous batching pays
    roughly the mean.  Arrivals are Poisson with ``arrival_rate``
    requests per scheduler tick.
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(arrival_rate, 1e-9), size=n_requests)
    arrivals = np.floor(np.cumsum(gaps)).astype(int)
    reqs = []
    for i in range(n_requests):
        p = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        lo, hi = gen_long if rng.random() < p_long else gen_short
        g = int(rng.integers(lo, hi + 1))
        toks = rng.integers(0, vocab, size=p)
        reqs.append(Request(rid=i, tokens=tuple(int(t) for t in toks),
                            max_new=g, arrival=int(arrivals[i])))
    return reqs


def repetitive_workload(seed: int, n_requests: int, *, vocab: int = 512,
                        prompt_len: int = 24,
                        gen: Tuple[int, int] = (32, 48),
                        num_classes: int = 2,
                        concentration: float = 0.02,
                        arrival_rate: float = 0.5) -> List[Request]:
    """Repetitive-continuation workload for speculative decode.

    Prompts are ``SyntheticTokens`` Markov walks with a *peaky*
    transition matrix (small Dirichlet ``concentration``): the walks
    revisit short token patterns constantly, and greedy decode on top of
    them settles into cycles — both give n-gram prompt lookup real hits,
    the regime where draft-free speculation pays.  Long-ish generation
    budgets keep the run decode-dominated.
    """
    from repro_torch.data.synthetic import SyntheticTokens
    src = SyntheticTokens(vocab=vocab, num_classes=num_classes,
                          concentration=concentration, seed=seed,
                          n_examples=n_requests)
    rng = np.random.default_rng(seed + 1)
    gaps = rng.exponential(1.0 / max(arrival_rate, 1e-9), size=n_requests)
    arrivals = np.floor(np.cumsum(gaps)).astype(int)
    walks = src.batch_at(np.arange(n_requests), prompt_len)["tokens"]
    return [Request(rid=i, tokens=tuple(int(t) for t in walks[i][:prompt_len]),
                    max_new=int(rng.integers(gen[0], gen[1] + 1)),
                    arrival=int(arrivals[i]))
            for i in range(n_requests)]


def shared_prefix_workload(seed: int, n_requests: int, *, vocab: int = 512,
                           prefix_len: int = 64, suffix_len: int = 8,
                           gen: Tuple[int, int] = (12, 20),
                           p_dup: float = 0.25,
                           arrival_gap: int = 4) -> List[Request]:
    """Shared-prefix workload for copy-on-write prefix sharing.

    Every prompt opens with the SAME ``prefix_len``-token system prompt
    (one Markov walk); a ~``p_dup`` fraction then repeats one shared
    continuation too (identical full prompts — these exercise the COW
    boundary-page path; a deterministic quota rather than a coin flip,
    so the COW path is ALWAYS represented), the rest append a unique
    random suffix.  Arrivals are staggered ``arrival_gap`` ticks apart
    so the first request's prefill has registered its pages before
    followers admit — the regime where admission-time prefix matching
    can skip most prefill work.
    """
    from repro_torch.data.synthetic import SyntheticTokens
    src = SyntheticTokens(vocab=vocab, num_classes=1, concentration=0.05,
                          seed=seed, n_examples=2)
    walk = src.batch_at(np.array([0]),
                        prefix_len + suffix_len)["tokens"][0]
    prefix = tuple(int(t) for t in walk[:prefix_len])
    shared_tail = tuple(int(t) for t in walk[prefix_len:prefix_len + suffix_len])
    rng = np.random.default_rng(seed + 1)
    stride = max(2, round(1.0 / p_dup)) if p_dup > 0 else 0
    reqs = []
    for i in range(n_requests):
        if stride and i % stride == stride - 1:
            tail = shared_tail
        else:
            tail = tuple(int(t) for t in
                         rng.integers(0, vocab, size=suffix_len))
        reqs.append(Request(rid=i, tokens=prefix + tail,
                            max_new=int(rng.integers(gen[0], gen[1] + 1)),
                            arrival=i * arrival_gap))
    return reqs
