"""Traced PS simulator: host-side schedule pass + a replay of the event
trace over the flat store (the port of the reference's
``cluster/trace.py``).

The event-driven simulator's timeline is **gradient-independent**: which
worker fires when, at what lr / update factor / batch size, how the sync
policy gates it, where jitter lands and when epoch evaluations fire are all
pure functions of the time models + policy + seed.  This module splits the
simulation into two passes:

  1. **schedule pass** (``schedule_pass``) — the exact event loop
     (``simulator.run_event_loop``) with all device work stripped,
     emitting a dense ``SimTrace``: numpy arrays of per-event
     ``worker_id`` / ``lr`` / ``update_factor`` / ``batch_size`` /
     ``stream_step`` plus epoch-eval markers and the final simulated
     clock.  Because it is the *same* loop, event order is faithful by
     construction.
  2. **execute pass** (``execute_trace``) — the events in chunks (powers of
     two, aligned to the evals), over batches staged a chunk at a time,
     carrying the flat parameter store (``repro_torch.core.flat``) plus ONE
     stacked ``(n_workers, rows, LANE)`` velocity buffer; each event takes
     its gradient through the store's views and runs the momentum +
     factor-scaled server push as ONE ``dbl_apply_worker_flat2d`` launch
     (B3), with the event's wid / lr / factor passed by value from the
     trace's host arrays.

Batches are staged host-side in event order: either through a
``repro_torch.data.DataPlane`` (``plane.trace_feed`` — counter-keyed
``(seed, phase, worker, step)`` streams, ``trace.stream_step`` being
exactly the per-worker counters the event path's ``sim_data_fn`` would
have used) or by calling a ``data_fn(rng, wid, bsz)`` in event order
(``data_fn_feed``, reproducing the shared-generator draw sequence draw for
draw).  Either way sample selection equals the event path's, and — because
eager PyTorch runs the same backward and the same per-event float op order
on both paths — so do the final params, history, ``n_pushes`` and
``sim_time`` for f32 params (``repro_torch.engine.parity
.check_trace_parity``).  Under ``precision="bf16"`` the carry is the bf16
store + f32 master pair, gradients are taken through the rounded weights,
and the run matches the f32 event path within a tolerance band instead;
timeline facts stay exact.

What the reference has and the port does not: the chunk is a plain Python
loop over its events, so the ``loop`` (XLA unroll vs ``lax.scan``) and
``interpret`` (Pallas interpret mode) arguments and the compiled-runner
caches (``trace_runner_for``, ``trace_scan_cache_size``) are gone; the
size switch (``lax.switch``) is a slice of the padded event batch by a
host integer.  The autotuner's batched replay (``execute_trace_batched``,
``batched_trace_runner_for``, ``_zip_feeds``) waits for the tuning slice
(ROADMAP A10).

The event path remains the right tool when per-event control flow must
*react* to gradients — the trace is only valid while the timeline stays
gradient-independent.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.cluster.simulator import SimResult, run_event_loop
from repro_torch.cluster.sync import SyncPolicy, as_policy
from repro_torch.cluster.topology import ClusterEvent, WorkerSpec
from repro_torch.core.flat import flat_spec
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels.dbl_merge import (dbl_apply_worker_flat2d,
                                           dbl_apply_worker_plain)

UPDATES = ("auto", "pallas", "xla")


@dataclass(frozen=True)
class SimTrace:
    """The dense, device-free record of one simulated run's timeline.

    Per-event arrays (length ``n_events``, execution order):
      worker_id      which worker fired
      lr             the epoch schedule's rate at that event
      update_factor  the worker's model-update factor (paper §3.4)
      batch_size     the worker's batch size (B_L or B_S)
      stream_step    the worker's own iteration counter at the event — THE
                     ``(seed, phase, worker, step)`` DataPlane stream key,
                     identical to the per-worker counters the event path's
                     ``sim_data_fn`` closures would have advanced

    evals: ``(events_done, epoch, sim_time)`` markers — an epoch eval
    fires after ``events_done`` events have executed.  sim_time /
    n_pushes / n_workers summarize the run (n_workers includes joiners,
    sizing the stacked velocity buffer).
    """
    worker_id: np.ndarray
    lr: np.ndarray
    update_factor: np.ndarray
    batch_size: np.ndarray
    stream_step: np.ndarray
    evals: Tuple[Tuple[int, int, float], ...]
    sim_time: float
    n_pushes: int
    n_workers: int
    sizes: Tuple[int, ...] = field(default=())   # distinct batch sizes

    @property
    def n_events(self) -> int:
        return int(len(self.worker_id))

    def size_class(self) -> np.ndarray:
        """Per-event index into ``sizes`` (the reference executor's switch
        branch)."""
        return np.searchsorted(np.asarray(self.sizes),
                               self.batch_size).astype(np.int32)

    def segments(self) -> List[Tuple[int, int, List[Tuple[int, float]]]]:
        """``(e0, e1, fired)`` spans between eval boundaries: events
        [e0, e1) execute, then every ``(epoch, sim_time)`` in ``fired``
        evaluates.  Consecutive evals with no events in between (a slow
        joiner's epochs collapsing) land in one span's ``fired`` list."""
        out: List[Tuple[int, int, List[Tuple[int, float]]]] = []
        e0 = 0
        for done, epoch, t in self.evals:
            if out and out[-1][1] == done:
                out[-1][2].append((epoch, t))
                continue
            out.append((e0, done, [(epoch, t)]))
            e0 = done
        if e0 < self.n_events:
            out.append((e0, self.n_events, []))
        return out


def schedule_pass(workers: Sequence[WorkerSpec], *, epochs: int,
                  lr_for_epoch: Callable[[int], float],
                  sync: Union[str, SyncPolicy] = "asp", staleness: int = 3,
                  seed: int = 0,
                  events: Sequence[ClusterEvent] = ()) -> SimTrace:
    """Run the event loop with all device work stripped -> ``SimTrace``.

    Same loop, same jitter streams, same membership handling as
    ``simulate()`` — the hooks record instead of computing, so the trace
    replays the event path's order faithfully by construction.
    """
    policy = as_policy(sync, staleness)
    wid_l: List[int] = []
    lr_l: List[float] = []
    fac_l: List[float] = []
    bsz_l: List[int] = []
    step_l: List[int] = []
    counters: dict = {}
    evals: List[Tuple[int, int, float]] = []

    def execute(wid: int, w: WorkerSpec, lr: float):
        t = counters.get(wid, 0)
        counters[wid] = t + 1
        wid_l.append(wid)
        lr_l.append(float(lr))
        fac_l.append(float(w.update_factor))
        bsz_l.append(int(w.batch_size))
        step_l.append(t)

    def evaluate(epoch: int, now: float):
        evals.append((len(wid_l), epoch, now))

    n_workers = {"n": len(workers)}

    def on_join(wid: int, spec: WorkerSpec):
        n_workers["n"] = max(n_workers["n"], wid + 1)

    sim_time, n_pushes = run_event_loop(
        workers, epochs=epochs, lr_for_epoch=lr_for_epoch, policy=policy,
        seed=seed, events=events, execute=execute, evaluate=evaluate,
        on_join=on_join)
    return SimTrace(
        worker_id=np.asarray(wid_l, np.int32),
        lr=np.asarray(lr_l, np.float32),
        update_factor=np.asarray(fac_l, np.float32),
        batch_size=np.asarray(bsz_l, np.int32),
        stream_step=np.asarray(step_l, np.int32),
        evals=tuple(evals), sim_time=sim_time, n_pushes=n_pushes,
        n_workers=n_workers["n"],
        sizes=tuple(sorted(set(bsz_l))) if bsz_l else ())


# --------------------------------------------------------------------------
# batch staging: event-order feeds
# --------------------------------------------------------------------------
def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def stack_event_batches(batches: List[dict], b_max: int, out=None) -> dict:
    """Stack per-event host batches (dicts whose arrays lead with the
    batch axis — the ``data_fn`` contract) along a new leading axis,
    padding each to ``b_max`` rows with zeros (the executor slices back to
    the event's true batch size, so pad content is never read).  ``out``
    (``{key: array}``, e.g. numpy views of pinned buffers) receives the
    stack in place of fresh arrays."""
    stacked = {}
    for k in batches[0]:
        arrs = [_host(b[k]) for b in batches]
        shape = (len(arrs), b_max) + arrs[0].shape[1:]
        buf = np.zeros(shape, arrs[0].dtype) if out is None else out[k]
        if out is not None:
            buf[...] = 0
        for i, a in enumerate(arrs):
            buf[i, :a.shape[0]] = a
        stacked[k] = buf
    return stacked


def _b_max(trace: SimTrace) -> int:
    return int(trace.sizes[-1]) if trace.sizes else 1


def data_fn_feed(data_fn: Callable, seed: int, device, *,
                 prefetch: bool = True):
    """Event-order staging from the ``data_fn(rng, wid, bsz)`` contract:
    ONE shared generator seeded like ``simulate()``'s, drawn in event order
    across chunk boundaries — so the staged samples are draw-for-draw the
    ones the event path would have consumed.  With ``prefetch`` the next
    chunk's host batches are drawn and stacked on a background thread
    while the current chunk runs (a single-worker pool keeps the draw
    order sequential); the copy to ``device`` happens in the consumer."""
    from repro_torch.data.plane import prefetch_iter
    device = torch.device(device)

    def feed(trace: SimTrace, ranges: Sequence[Tuple[int, int]]):
        rng = np.random.Generator(np.random.PCG64(seed))
        b_max = _b_max(trace)

        def stage(e0: int, e1: int):
            return stack_event_batches(
                [data_fn(rng, int(trace.worker_id[e]),
                         int(trace.batch_size[e])) for e in range(e0, e1)],
                b_max)

        def to_device(host):
            return {k: torch.from_numpy(v).to(device)
                    for k, v in host.items()}

        if not prefetch or len(ranges) <= 1:
            for host in prefetch_iter(stage, ranges, None):
                yield to_device(host)
            return
        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="trace-feed") as ex:
            for host in prefetch_iter(stage, ranges, ex):
                yield to_device(host)
    return feed


# --------------------------------------------------------------------------
# the execute pass
# --------------------------------------------------------------------------
def _chunk_ranges(trace: SimTrace, scan_chunk: int):
    """(e0, e1) chunk spans: eval segments split into power-of-two pieces
    <= scan_chunk (eval boundaries must align with chunk boundaries — the
    executor leaves the store only to evaluate)."""
    cap = 1
    while cap * 2 <= max(1, scan_chunk):
        cap *= 2
    ranges = []
    for e0, e1, _fired in trace.segments():
        g = e0
        while g < e1:
            c = cap
            while c > e1 - g:
                c //= 2
            ranges.append((g, g + c))
            g += c
    return ranges


def trace_signature(trace: SimTrace) -> tuple:
    """Everything that must match for two traces to share one batched
    replay (ROADMAP A10): worker/batch/stream timeline, eval markers,
    sizes and worker count.  Per-event lr / update_factor are NOT in the
    signature."""
    return (trace.n_workers, trace.sizes, trace.evals,
            trace.worker_id.tobytes(), trace.batch_size.tobytes(),
            trace.stream_step.tobytes())


def _make_event(grad_fn: Callable, spec, update: str):
    """One simulated-PS event on the flat carry, in place: the gradient at
    the event's batch (the padded batch sliced back to its true size by a
    host integer), taken through the store's views, then the fused
    momentum + factor-scaled server push.

    On a bf16 spec the param carry is the ``(shadow, master)`` pair:
    gradients differentiate through the bf16 shadow (``unravel`` upcasts,
    so only stored weights are rounded) but stay f32 all the way to the
    update (``ravel_master`` shares the geometry); the update writes the
    f32 master and its re-rounded shadow in the same sweep."""
    mixed = spec.store_dtype != torch.float32
    apply = dbl_apply_worker_plain if update == "xla" \
        else dbl_apply_worker_flat2d

    def event(p2c, vel3, batch, bsz, wid, lr, factor, momentum):
        shadow = p2c[0] if mixed else p2c
        g = grad_fn(spec.unravel(shadow),
                    {k: v[:bsz] for k, v in batch.items()})
        with torch.no_grad():
            if mixed:
                apply(shadow, spec.ravel_master(g), vel3, wid, lr, factor,
                      momentum, master2=p2c[1])
            else:
                apply(p2c, spec.ravel(g), vel3, wid, lr, factor, momentum)
    return event


def execute_trace(init_params, grad_fn: Callable, trace: SimTrace, *,
                  data_fn: Optional[Callable] = None,
                  feed=None, momentum: float = 0.9,
                  eval_fn: Optional[Callable] = None, seed: int = 0,
                  scan_chunk: int = 32, prefetch: bool = True,
                  update: str = "auto",
                  precision: str = "f32") -> SimResult:
    """Replay a ``SimTrace`` over the flat store, on ``init_params``'
    device (which are never written: the store is a copy).

    Carries ``(flat params, stacked velocity)`` through chunks of events
    (power-of-two lengths bounded by ``scan_chunk`` and eval boundaries),
    leaving the store only at epoch evals.  Batches come from
    ``feed(trace, ranges)`` (e.g. a ``DataPlane.trace_feed`` binding) or,
    when only a ``data_fn`` is given, from ``data_fn_feed`` (event-order
    draws from one shared generator, exactly like ``simulate()``).
    ``update`` picks the per-event server update: ``"auto"`` and
    ``"pallas"`` call the B3 wrapper (the CUDA kernel for CUDA tensors,
    its plain version for CPU ones), ``"xla"`` the plain version directly
    (the parity tests' second form); the float op order is the same, so
    the choice never moves a bit.  ``precision="bf16"`` carries the bf16
    store + f32 master pair instead (evals and final params read the
    master).
    """
    if update not in UPDATES:
        raise ValueError(f"unknown update {update!r} (expected one of "
                         f"{UPDATES})")
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
    device = tree_leaves(init_params)[0].device
    if feed is None:
        if data_fn is None:
            raise ValueError("execute_trace needs a feed or a data_fn")
        feed = data_fn_feed(data_fn, seed, device, prefetch=prefetch)
    mixed = precision != "f32"
    spec = (flat_spec(init_params, torch.bfloat16) if mixed
            else flat_spec(init_params))
    p2 = ((spec.ravel(init_params), spec.ravel_master(init_params))
          if mixed else spec.ravel(init_params))
    vel3 = spec.zeros_stacked(max(1, trace.n_workers), device=device)
    history: List[dict] = []

    def fire(fired):
        for epoch, t in fired:
            rec = {"epoch": epoch, "sim_time": t}
            if eval_fn is not None:
                rec.update(eval_fn(spec.unravel(p2[1] if mixed else p2)))
            history.append(rec)

    ranges = _chunk_ranges(trace, scan_chunk)
    event = _make_event(grad_fn, spec, update)
    seg_iter = iter(trace.segments())
    seg = next(seg_iter, None)
    for (e0, e1), batches in zip(ranges, feed(trace, ranges)):
        for j, e in enumerate(range(e0, e1)):
            event(p2, vel3, {k: v[j] for k, v in batches.items()},
                  int(trace.batch_size[e]), int(trace.worker_id[e]),
                  trace.lr[e], trace.update_factor[e], momentum)
        while seg is not None and e1 >= seg[1]:
            fire(seg[2])
            seg = next(seg_iter, None)
    while seg is not None:              # trailing zero-event segments
        fire(seg[2])
        seg = next(seg_iter, None)
    return SimResult(sim_time=trace.sim_time, history=history,
                     params=spec.unravel(p2[1] if mixed else p2),
                     n_pushes=trace.n_pushes)


def simulate_traced(init_params, grad_fn: Callable,
                    data_fn: Optional[Callable],
                    workers: Sequence[WorkerSpec], *, epochs: int,
                    lr_for_epoch: Callable[[int], float],
                    sync: Union[str, SyncPolicy] = "asp",
                    staleness: int = 3, momentum: float = 0.9,
                    eval_fn: Optional[Callable] = None, seed: int = 0,
                    events: Sequence[ClusterEvent] = (), feed=None,
                    scan_chunk: int = 32, prefetch: bool = True,
                    update: str = "auto",
                    precision: str = "f32") -> SimResult:
    """Drop-in ``simulate()`` replacement on the traced path: schedule pass
    (host) + execute pass (flat store, one B3 launch per event).  Same
    arguments, same ``SimResult`` — bit-identical to the event path for
    f32 params on the CPU (``engine.parity.check_trace_parity``); under
    ``precision="bf16"`` the replay carries the bf16 store + f32 master
    pair and matches the event path within a tolerance band instead."""
    trace = schedule_pass(workers, epochs=epochs,
                          lr_for_epoch=lr_for_epoch, sync=sync,
                          staleness=staleness, seed=seed, events=events)
    return execute_trace(init_params, grad_fn, trace, data_fn=data_fn,
                         feed=feed, momentum=momentum, eval_fn=eval_fn,
                         seed=seed, scan_chunk=scan_chunk,
                         prefetch=prefetch, update=update,
                         precision=precision)
