"""Event-driven parameter-server simulator (paper §2.3/2.4, faithful form)
— the port of the reference's ``cluster/simulator.py``.

Logical workers own local replicas and push factor-scaled deltas to a
central server under a pluggable ``SyncPolicy`` (BSP / ASP / SSP objects —
no string ladder in the hot loop).  *Gradients are real* (PyTorch, on the
actual model); *time is simulated* from the paper's linear time model
(Eq. 2), so staleness patterns, straggler effects and the simulated
wall-clock match the paper's cluster without needing one.

Cluster realism knobs (all deterministic under a fixed seed):

  * per-worker iteration times (heterogeneous ``LinearTimeModel``s via
    ``topology.workers_from_plan``);
  * ``WorkerSpec.jitter`` — lognormal multiplicative noise on iteration
    time (straggler injection);
  * ``ClusterEvent``s — elastic join/leave mid-run; departed workers stop
    gating sync and epoch evaluation.

The timeline itself — event order, per-event lr / update factor / batch
size, sync gating, jitter draws, elastic membership and epoch-eval
boundaries — is **gradient-independent**: a pure function of the time
models, policy and seed.  ``run_event_loop`` is that pure loop, carried
over line for line from the reference, with the device work injected
through ``execute`` / ``evaluate`` hooks; ``simulate`` plugs in real
PyTorch updates (the event path, one gradient and one update per event),
and ``repro_torch.cluster.trace.schedule_pass`` plugs in recorders to
emit a dense ``SimTrace`` that the traced executor replays over the flat
store.

The per-event update (``local_update``) is eager tensor math in the
reference's float op order — ``v = m·v + g``, ``d = −lr·v``,
``w = w + f·d`` — each op rounded on its own.  Two pieces of the reference
exist only for XLA and are not ported: the ``optimization_barrier`` that
pins the gradient before the update (eager PyTorch never fuses the update
into the backward pass, so there is nothing to pin), and the weak compile
cache of the jitted update (``local_update_for``,
``local_update_cache_size``: eager code compiles nothing).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.cluster.sync import SyncPolicy, as_policy
from repro_torch.cluster.topology import ClusterEvent, WorkerSpec
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten


@dataclass
class SimResult:
    sim_time: float
    history: List[dict] = field(default_factory=list)   # per-epoch evals
    params: object = None
    n_pushes: int = 0        # server updates applied (jitter/elastic audits)


def local_update(params, vel, grads, lr: float, momentum: float,
                 factor: float):
    """One worker's momentum step and factor-scaled server push over
    parameter trees, as the reference's jitted ``local_update``:

        v' = m·v + g;   d = −lr·v';   w' = w + f·d

    ``torch._foreach_*`` keeps one launch per op for the whole tree; each
    op still rounds on its own, so the result is bit-equal to the same
    math over the flat store (``kernels.dbl_merge.dbl_apply_worker_*``).
    Returns new ``(params, velocity)`` trees; the inputs are not written.
    """
    w, treedef = tree_flatten(params)
    v = tree_flatten(vel)[0]
    g = tree_flatten(grads)[0]
    v = torch._foreach_add(torch._foreach_mul(v, float(momentum)), g)
    d = torch._foreach_mul(v, -float(lr))
    w = torch._foreach_add(w, torch._foreach_mul(d, float(factor)))
    return tree_unflatten(treedef, w), tree_unflatten(treedef, v)


def run_event_loop(workers: Sequence[WorkerSpec], *, epochs: int,
                   lr_for_epoch: Callable[[int], float],
                   policy: SyncPolicy, seed: int = 0,
                   events: Sequence[ClusterEvent] = (),
                   execute: Callable[[int, WorkerSpec, float], None],
                   evaluate: Callable[[int, float], None],
                   on_join: Optional[Callable[[int, WorkerSpec], None]]
                   = None) -> tuple:
    """Drive the gradient-independent PS timeline.

    Pops worker-completion events off a heap under the sync policy's
    staleness gate, applies elastic membership changes, draws straggler
    jitter and fires epoch evaluations — everything the simulated cluster
    decides, with the actual training work abstracted behind hooks:

      execute(wid, spec, lr)   one worker iteration in execution order
                               (device update in ``simulate``; trace
                               recording in the schedule pass)
      evaluate(epoch, now)     an epoch boundary fired (the slowest
                               non-departed worker finished epoch ``epoch``)
      on_join(wid, spec)       a joiner entered (allocate per-worker state)

    Returns ``(sim_time, n_pushes)``.  The hooks see the exact event order
    the device path executes, so a trace recorded here replays it
    faithfully by construction.
    """
    specs: List[WorkerSpec] = list(workers)
    n0 = len(specs)
    total_iters = [epochs * w.iters_per_epoch for w in specs]
    done_iters = [0] * n0
    base_iters = [0] * n0    # joiners start at the cluster frontier
    epoch_done = [0] * n0
    departed = [False] * n0

    def _worker_rng(wid: int) -> np.random.RandomState:
        """Jitter stream per (seed, worker) — joiners and initial workers
        must draw from the same mixer for run-to-run determinism."""
        return np.random.RandomState((seed * 1000003 + 7919 * wid) % 2**32)

    jit_rngs = [_worker_rng(i) for i in range(n0)]
    sim_time = 0.0
    evaluated_epochs = 0
    n_pushes = 0

    def duration(wid: int) -> float:
        w = specs[wid]
        if w.jitter > 0:
            return w.iter_time * float(
                np.exp(w.jitter * jit_rngs[wid].standard_normal()))
        return w.iter_time

    # event queue: (ready_time, worker_id)
    heap = [(duration(i), i) for i in range(n0)]
    heapq.heapify(heap)
    waiting: List[int] = []     # SSP-suspended workers
    timeline = sorted(events, key=lambda e: e.time)
    ev_i = 0

    def maybe_eval(now):
        nonlocal evaluated_epochs
        while True:
            alive = [epoch_done[i] for i in range(len(specs))
                     if not departed[i]]
            if not alive or min(alive) <= evaluated_epochs:
                return
            evaluated_epochs += 1
            evaluate(evaluated_epochs, now)

    def min_active_iters() -> int:
        """Finished and departed workers must not gate progress."""
        active = [done_iters[i] for i in range(len(specs))
                  if not departed[i] and done_iters[i] < total_iters[i]]
        if active:
            return min(active)
        return max(done_iters) if done_iters else 0

    def release_waiting(now):
        """Re-queue SSP-suspended workers whose gap closed."""
        nonlocal waiting
        still = []
        m = min_active_iters()      # invariant across the scan
        for v in waiting:
            if departed[v]:
                continue
            if policy.allows(done_iters[v], m):
                heapq.heappush(heap, (max(now, sim_time) + 1e-9, v))
            else:
                still.append(v)
        waiting = still

    def add_worker(spec: WorkerSpec, now: float) -> int:
        wid = len(specs)
        # join at the cluster's current iteration frontier: a fresh worker
        # starting from iteration 0 would drag min_active_iters to 0 and
        # suspend the whole cluster under BSP/SSP until it serially caught
        # up — elastic capacity must not stall the existing members
        base = min_active_iters()
        specs.append(spec)
        if on_join is not None:
            on_join(wid, spec)
        base_iters.append(base)
        total_iters.append(base + epochs * spec.iters_per_epoch)
        done_iters.append(base)
        epoch_done.append(0)
        departed.append(False)
        jit_rngs.append(_worker_rng(wid))
        heapq.heappush(heap, (now + duration(wid), wid))
        return wid

    while heap or waiting or ev_i < len(timeline):
        # elastic membership events fire before any later worker completion
        next_t = heap[0][0] if heap else math.inf
        if ev_i < len(timeline) and timeline[ev_i].time <= next_t:
            ev = timeline[ev_i]
            ev_i += 1
            # membership changes do not advance the clock themselves — only
            # executed work does (a trailing leave for an already-finished
            # worker must not inflate the reported sim_time; a joiner's own
            # iterations advance it naturally)
            if ev.action == "join":
                add_worker(ev.worker, ev.time)
            else:
                if not 0 <= ev.worker_id < len(specs):
                    raise ValueError(f"leave event for unknown worker "
                                     f"{ev.worker_id}")
                departed[ev.worker_id] = True
                waiting = [v for v in waiting if v != ev.worker_id]
            # a departed straggler may unblock SSP waiters / epoch evals;
            # a freed worker resumes at the event time, not back-dated
            release_waiting(ev.time)
            maybe_eval(sim_time)
            continue
        if not heap:   # all runnable workers suspended, no events left
            raise RuntimeError("SSP deadlock (all workers waiting)")
        now, wid = heapq.heappop(heap)
        if departed[wid]:
            continue
        sim_time = max(sim_time, now)
        w = specs[wid]

        # sync gate: one polymorphic call, no per-semantics branches
        if not policy.allows(done_iters[wid], min_active_iters()):
            waiting.append(wid)
            # it will be re-queued when the slowest worker advances
            continue

        # one worker iteration; epoch progress is measured from the
        # worker's own base (joiners start mid-frontier)
        own_iters = done_iters[wid] - base_iters[wid]
        lr = lr_for_epoch(min(own_iters // w.iters_per_epoch, epochs - 1))
        execute(wid, w, lr)
        n_pushes += 1

        done_iters[wid] += 1
        if (done_iters[wid] - base_iters[wid]) % w.iters_per_epoch == 0:
            epoch_done[wid] += 1
            maybe_eval(now)

        if done_iters[wid] < total_iters[wid]:
            heapq.heappush(heap, (now + duration(wid), wid))

        release_waiting(now)

    maybe_eval(sim_time)
    return sim_time, n_pushes


def simulate(init_params, grad_fn: Callable, data_fn: Callable,
             workers: Sequence[WorkerSpec], *, epochs: int,
             lr_for_epoch: Callable[[int], float],
             sync: Union[str, SyncPolicy] = "asp",
             staleness: int = 3, momentum: float = 0.9,
             eval_fn: Optional[Callable] = None, seed: int = 0,
             events: Sequence[ClusterEvent] = ()) -> SimResult:
    """Run the PS simulation (the event path: one gradient and one update
    per event; see ``repro_torch.cluster.trace.simulate_traced`` for the
    traced form that replays the same timeline over the flat store).

    init_params: a tree of tensors; the run happens on their device and
      never writes them.
    grad_fn(params, batch) -> grads (same tree as params)
    data_fn(rng, worker_id, batch_size) -> batch, where ``rng`` is a seeded
      ``numpy.random.Generator`` shared across the run (draw batch indices
      host-side from it — e.g. ``rng.integers(0, n, size=batch_size)``);
      draws happen in event-execution order.
    eval_fn(params) -> dict of metrics, called at each epoch boundary
      (epoch = when the *slowest* non-departed worker finishes its
      allocation).
    sync: a ``SyncPolicy`` (BSP()/ASP()/SSP(s)) or the string spelling;
      ``staleness`` only applies to the "ssp" string.
    events: elastic ``ClusterEvent`` join/leave timeline.
    """
    policy = as_policy(sync, staleness)

    state = {"params": init_params}
    velocity = [tree_map(torch.zeros_like, init_params) for _ in workers]
    data_rng = np.random.Generator(np.random.PCG64(seed))
    history: List[dict] = []

    def on_join(wid: int, spec: WorkerSpec):
        velocity.append(tree_map(torch.zeros_like, init_params))

    def execute(wid: int, w: WorkerSpec, lr: float):
        batch = data_fn(data_rng, wid, w.batch_size)
        grads = grad_fn(state["params"], batch)
        with torch.no_grad():
            state["params"], velocity[wid] = local_update(
                state["params"], velocity[wid], grads, lr, momentum,
                w.update_factor)

    def evaluate(epoch: int, now: float):
        rec = {"epoch": epoch, "sim_time": now}
        if eval_fn is not None:
            rec.update(eval_fn(state["params"]))
        history.append(rec)

    sim_time, n_pushes = run_event_loop(
        workers, epochs=epochs, lr_for_epoch=lr_for_epoch, policy=policy,
        seed=seed, events=events, execute=execute, evaluate=evaluate,
        on_join=on_join)
    return SimResult(sim_time=sim_time, history=history,
                     params=state["params"], n_pushes=n_pushes)
