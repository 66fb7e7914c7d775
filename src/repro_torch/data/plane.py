"""The DataPlane: ONE resolution-aware input pipeline (the port of the
reference's ``data/plane.py``).

  * **canonical sample streams** — every batch is drawn from
    ``pipeline.stream_indices``, keyed on ``(seed, phase, worker, step)``,
    so the port draws exactly the reference's samples;
  * **resolution awareness** — batches materialize host-side at each
    ``Phase.input_size`` (images resize bilinearly);
  * **double-buffered scan feed** — ``scan_feed`` stages the NEXT chunk on
    a background thread while the engine runs the current one.  On a CUDA
    device the chunk is stacked straight into pinned host memory and
    copied with ``non_blocking=True`` on a side stream; an event recorded
    there is what the consumer's stream waits on, so the copy overlaps the
    running steps and never races them;
  * **structs** — ``batch_struct`` gives ``(shape, dtype)`` pairs for any
    phase without materializing data.

Contracts served:

    plane(phase, gstep)                      -> host batch dict (numpy)
    plane.scan_feed(phase, g0, n, chunk, device)   (engine loop)
    plane.sim_data_fn(i, phase, device)      -> data_fn (PS-sim event path)
    plane.trace_feed(i, phase, device)       -> feed    (traced PS-sim)
    plane.batch_struct(phase[, stacked])

``bind(phases)`` pins the schedule so a ``Phase`` object resolves to its
index (and absolute start step); the backend binds automatically.  The
prefetch thread belongs to the plane: ``close()`` (or leaving a ``with``
block, or interpreter exit) shuts it down.  ``trace_feed`` stages its
chunks of simulator events the same way as ``scan_feed``.
"""
from __future__ import annotations

import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import stream_indices


def prefetch_iter(stage, items, executor=None):
    """Double-buffered staging: yield ``stage(*item)`` for each item, with
    the NEXT item staged on ``executor`` (a single-worker pool — FIFO, so
    stateful stages keep their call order) while the caller consumes the
    current one.  ``executor=None`` stages synchronously.  Cancels the
    in-flight future if the consumer abandons the iterator early."""
    items = list(items)
    if executor is None or len(items) <= 1:
        for it in items:
            yield stage(*it)
        return
    fut = executor.submit(stage, *items[0])
    try:
        for i in range(len(items)):
            staged = fut.result()
            fut = (executor.submit(stage, *items[i + 1])
                   if i + 1 < len(items) else None)
            yield staged
    finally:
        if fut is not None:
            fut.cancel()


def _shutdown(pool: ThreadPoolExecutor) -> None:
    pool.shutdown(wait=True, cancel_futures=True)


class DataPlane:
    """One input pipeline for every backend (see module docstring).

    source: anything speaking the source contract — ``len(source)``,
      ``batch_at(indices, input_size)``, ``struct(batch, input_size)``
      (``repro_torch.data.synthetic`` datasets do).
    seed: stream seed; per-phase streams depend only on ``(seed, phase
      index)``.
    prefetch: double-buffer ``scan_feed`` chunks on a background thread
      (False = stage synchronously; the batches are identical either way).
    """

    def __init__(self, source, *, seed: int = 0, prefetch: bool = True):
        self.source = source
        self.seed = int(seed)
        self.prefetch = bool(prefetch)
        self._phases: Optional[Tuple] = None
        self._starts: Tuple[int, ...] = ()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()
        self._finalizer = None
        self._streams: dict = {}

    # -- lifetime --------------------------------------------------------
    def close(self) -> None:
        """Stop the prefetch thread (cancelling staged work) and drop the
        side streams.  The plane stays usable; a later feed restarts the
        thread."""
        with self._pool_lock:
            finalizer, self._pool, self._finalizer = \
                self._finalizer, None, None
            self._streams.clear()
        if finalizer is not None:
            finalizer()             # joins the thread (outside the lock a
            #                         staging task may still need)

    def __enter__(self) -> "DataPlane":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- schedule binding ------------------------------------------------
    def bind(self, phases: Sequence) -> "DataPlane":
        """Pin the phase list so ``Phase`` objects resolve to stream
        indices/start steps.  Called by the backend; idempotent."""
        phases = tuple(phases)
        starts, ofs = [], 0
        for p in phases:
            starts.append(ofs)
            ofs += p.n_steps
        self._phases = phases
        self._starts = tuple(starts)
        return self

    @property
    def bound(self) -> bool:
        return self._phases is not None

    def _locate(self, phase) -> Tuple[int, int]:
        """(phase index, absolute start step) for ``phase``.  Identity
        wins; the equality fallback refuses ambiguous matches — a cyclic
        schedule may legitimately contain equal phases."""
        if self._phases is None:
            return 0, 0
        for i, p in enumerate(self._phases):
            if p is phase:
                return i, self._starts[i]
        eq = [i for i, p in enumerate(self._phases) if p == phase]
        if len(eq) == 1:
            return eq[0], self._starts[eq[0]]
        if eq:
            raise ValueError(
                f"phase equals schedule entries {eq} — ambiguous; pass the "
                "bound Phase object itself (identity) to disambiguate")
        raise ValueError("phase not in the bound schedule — rebind the "
                         "DataPlane with the phase list it is serving")

    # -- canonical streams ----------------------------------------------
    def worker_rows(self, phase):
        """Per worker-row block of the global padded batch:
        ``(wid, valid, rows)`` — ``valid`` samples drawn from the worker's
        stream, padded to ``rows`` (padding repeats the last valid sample;
        those rows carry weight 0 / are never indexed by the fused step)."""
        layout = phase.layout
        if layout is None:
            return [(0, phase.batch_size, phase.batch_size)]
        pw = layout.per_worker
        n_large = layout.n_workers - layout.n_small
        return [(w, pw if w < n_large else max(1, layout.small_valid), pw)
                for w in range(layout.n_workers)]

    def worker_indices(self, phase_idx: int, wid: int, step: int,
                       n: int) -> np.ndarray:
        """Worker ``wid``'s ``step``-th draw of ``n`` sample indices in
        phase ``phase_idx`` — THE canonical stream."""
        return stream_indices(len(self.source), n, seed=self.seed,
                              phase=phase_idx, wid=wid, step=step)

    def global_indices(self, phase, local_step: int) -> np.ndarray:
        """The global batch's sample indices at phase-local step
        ``local_step``: per-worker draws concatenated in worker order."""
        pi, _ = self._locate(phase)
        parts = []
        for w, valid, rows in self.worker_rows(phase):
            idx = self.worker_indices(pi, w, local_step, valid)
            if rows > valid:
                idx = np.concatenate(
                    [idx, np.repeat(idx[-1], rows - valid)])
            parts.append(idx)
        return np.concatenate(parts)

    # -- engine batch_fn contract ----------------------------------------
    def __call__(self, phase, gstep: int) -> dict:
        """batch_fn(phase, global_step) -> host (numpy) batch dict at the
        phase's input size; stateless in ``gstep``."""
        pi, start = self._locate(phase)
        idx = self.global_indices(phase, gstep - start)
        return self.source.batch_at(idx, phase.input_size)

    def batch_struct(self, phase, stacked: Optional[int] = None) -> dict:
        """``{key: (shape, dtype)}`` for ``phase`` (leading ``stacked``
        steps axis when given) — no data materialized."""
        out = {}
        for k, (shape, dt) in self.source.struct(phase.batch_size,
                                                 phase.input_size).items():
            full = ((stacked,) + tuple(shape)) if stacked else tuple(shape)
            out[k] = (full, dt)
        return out

    # -- double-buffered scan feed ----------------------------------------
    def _executor(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="dataplane-prefetch")
                # interpreter exit (or garbage collection) joins the
                # thread even when the owner never calls close()
                self._finalizer = weakref.finalize(self, _shutdown,
                                                   self._pool)
            return self._pool

    def _side_stream(self, device: torch.device) -> torch.cuda.Stream:
        with self._pool_lock:
            s = self._streams.get(device)
            if s is None:
                s = self._streams[device] = torch.cuda.Stream(device=device)
            return s

    def _upload(self, shapes: dict, fill, device: torch.device):
        """Allocate a chunk's host buffers (``{key: (shape, numpy
        dtype)}``, pinned on CUDA), let ``fill({key: numpy view})`` write
        them, and start the copy to ``device``: ``(tensors, event)``,
        ``event`` None off CUDA."""
        if device.type != "cuda":
            host = {k: np.empty(s, dt) for k, (s, dt) in shapes.items()}
            fill(host)
            return {k: torch.from_numpy(v).to(device)
                    for k, v in host.items()}, None
        pinned = {k: torch.empty(s, pin_memory=True, dtype=torch.from_numpy(
                      np.empty(0, dt)).dtype) for k, (s, dt) in shapes.items()}
        fill({k: t.numpy() for k, t in pinned.items()})
        stream = self._side_stream(device)
        with torch.cuda.stream(stream):
            out = {k: t.to(device, non_blocking=True)
                   for k, t in pinned.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    @staticmethod
    def _handoff(staged_iter, device: torch.device):
        """Yield each staged ``(tensors, event)`` as tensors ready for the
        caller's current stream."""
        for batches, event in staged_iter:
            if event is not None:
                cur = torch.cuda.current_stream(device)
                cur.wait_event(event)
                for t in batches.values():
                    # the side stream allocated them; tell the caching
                    # allocator the consumer's stream uses them too
                    t.record_stream(cur)
            yield batches

    def _stage_chunk(self, phase, g0: int, c: int, device: torch.device):
        """Host-build + stack ``c`` consecutive batches and start their
        upload: ``(tensors, event)``, ``event`` None off CUDA."""
        batches = [self(phase, g0 + j) for j in range(c)]

        def fill(out):
            for k, buf in out.items():
                np.stack([b[k] for b in batches], out=buf)
        return self._upload({k: ((c,) + v.shape, v.dtype)
                             for k, v in batches[0].items()}, fill, device)

    def scan_feed(self, phase, start: int, n_steps: int, chunk: int,
                  device) -> Iterator[Tuple[int, dict]]:
        """Yield ``(c, batches)`` chunks of tensors on ``device`` covering
        ``n_steps`` steps from absolute step ``start``; with ``prefetch``
        the next chunk stages on the background thread while the caller
        consumes the current one.  On CUDA each chunk is ready for the
        caller's current stream when yielded."""
        device = torch.device(device)
        items, g0, rem = [], start, n_steps
        while rem:
            c = min(rem, chunk)
            items.append((phase, g0, c, device))
            g0 += c
            rem -= c
        staged_iter = prefetch_iter(self._stage_chunk, items,
                                    self._executor() if self.prefetch
                                    else None)
        for (_, _, c, _), batches in zip(items,
                                         self._handoff(staged_iter, device)):
            yield c, batches

    # -- PS-sim contracts -------------------------------------------------
    def sim_data_fn(self, phase_idx: int, phase, device):
        """``data_fn(rng, wid, bsz)`` for one simulator phase, giving
        tensors on ``device``.  Ignores the simulator's shared rng: draws
        come from the per-worker counter stream instead, so the sample
        sequence is independent of event interleaving."""
        device = torch.device(device)
        counters: dict = {}

        def data_fn(rng, wid, bsz):
            t = counters.get(wid, 0)
            counters[wid] = t + 1
            idx = self.worker_indices(phase_idx, wid, t, bsz)
            b = self.source.batch_at(idx, phase.input_size)
            return {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        return data_fn

    def trace_feed(self, phase_idx: int, phase, device, *,
                   prefetch: Optional[bool] = None):
        """``feed(trace, ranges)`` for ``repro_torch.cluster.trace``'s
        execute pass: stages each event range of a ``SimTrace`` from the
        canonical per-``(seed, phase, worker, step)`` streams —
        ``trace.stream_step`` holds exactly the per-worker counters the
        event path's ``sim_data_fn`` closures would have advanced, so
        sample selection equals the event path's.  Each chunk is stacked
        into pinned memory (padded to the largest event batch) and copied
        to ``device`` on the side stream, as ``scan_feed`` does; with
        prefetch the next range stages on the background thread while the
        current one runs."""
        use_prefetch = self.prefetch if prefetch is None else bool(prefetch)
        device = torch.device(device)

        def feed(trace, ranges):
            from repro_torch.cluster.trace import stack_event_batches
            b_max = int(max(trace.sizes)) if trace.sizes else 1

            def stage(e0: int, e1: int):
                batches = [
                    self.source.batch_at(
                        self.worker_indices(phase_idx,
                                            int(trace.worker_id[e]),
                                            int(trace.stream_step[e]),
                                            int(trace.batch_size[e])),
                        phase.input_size)
                    for e in range(e0, e1)]
                shapes = {k: ((e1 - e0, b_max) + v.shape[1:], v.dtype)
                          for k, v in batches[0].items()}
                return self._upload(
                    shapes,
                    lambda out: stack_event_batches(batches, b_max, out=out),
                    device)

            yield from self._handoff(
                prefetch_iter(stage, ranges,
                              self._executor() if use_prefetch else None),
                device)
        return feed
