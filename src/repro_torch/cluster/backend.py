"""Cluster backends (the port of the reference's ``cluster/backend.py``):
two implementations of one contract, each running a ``Phase`` schedule and
returning a ``RunResult`` with the reference's unified per-phase history.

  * ``PsSimBackend`` — the paper's accuracy path: each phase is one
    simulator run (event path or traced replay) with workers from its
    dual-batch plan under the phase's input-size-rescaled time model(s);
    params carry across phases, per-epoch history concatenates with
    absolute sim-time offsets, and per-epoch LR schedules
    (``Phase.lr_for_epoch``) are honored.
  * ``SpmdBackend`` — the synchronous engine path (the paper's speed
    path), one phase at a time so phase boundaries are observable.

Both save a checkpoint at every phase boundary (``ckpt_dir``;
``checkpoint.ckpt``, the reference's file format): ``params`` and
``opt_state`` on the engine, ``params``, the float64 sim ``clock`` and the
int64 ``epochs`` count on the simulator.  ``resume=True`` restarts from
the latest saved boundary and replays the uninterrupted run's data order
and clock, because every stream depends only on ``(seed, phase index)``
or the global step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import restore_latest, save_checkpoint
from repro_torch.cluster.simulator import simulate
from repro_torch.cluster.sync import SyncPolicy, as_policy
from repro_torch.cluster.topology import ClusterEvent, workers_from_plan
from repro_torch.cluster.trace import simulate_traced
from repro_torch.core.flat import FlatParams
from repro_torch.core.time_model import LinearTimeModel
from repro_torch.core.tree import tree_leaves
from repro_torch.device import resolve_device, strict_f32


def _as_tree(params):
    """Accept a flat store anywhere a params tree is expected."""
    return params.to_tree() if isinstance(params, FlatParams) else params


def _restore(ckpt_dir: Optional[str], resume: bool, like: dict):
    """Latest phase-boundary checkpoint (or None) for a backend run."""
    if not (resume and ckpt_dir):
        return None, None
    return restore_latest(ckpt_dir, like)


def scaled_time_model(tm: LinearTimeModel, input_size: int, ref_size: int,
                      *, axis: str = "resolution") -> LinearTimeModel:
    """Per-sample cost scales with the input cost (r² or s); overhead b is
    size-independent (paper §4.2).  Thin front over
    ``LinearTimeModel.scaled`` (the canonical rescaling rule)."""
    return tm.scaled(input_size, ref_size, axis=axis)


def phase_seed(seed: int, phase_idx: int) -> int:
    """Per-phase RNG stream depending only on (seed, phase index), so a
    resumed run replays exactly the uninterrupted run's data order."""
    if phase_idx == 0:
        return seed
    return (seed * 1_000_003 + 0x9E3779B1 * phase_idx) % 2**31


def phase_record(idx: int, backend: str, phase, *, steps: int, time_s: float,
                 t0: float, metrics: dict) -> dict:
    """The unified per-phase history record both backends emit."""
    rec = {"phase": idx, "backend": backend,
           "input_size": phase.input_size, "batch_size": phase.batch_size,
           "lr": phase.lr, "steps": steps,
           "time": round(time_s, 6), "t0": round(t0, 6)}
    rec.update({k: v for k, v in metrics.items()
                if k not in ("epoch", "sim_time", "phase", "step")})
    return rec


@dataclass
class RunResult:
    """What every backend returns for a schedule run."""
    backend: str
    params: Any
    opt_state: Any = None
    time: float = 0.0               # sim seconds (ps_sim) / wall s (spmd)
    history: List[dict] = field(default_factory=list)   # concatenated
    phases: List[dict] = field(default_factory=list)    # phase_record()s
    resumed_from: Optional[int] = None   # phase boundary restored, if any

    @property
    def last(self) -> dict:
        return self.history[-1] if self.history else {}


class PsSimBackend:
    """Event-driven parameter-server backend (the paper's accuracy path).

    fns_factory(input_size) -> (grad_fn, data_fn, eval_fn); results are
    memoized per input size so cyclic schedules that revisit a size reuse
    the same functions.  grad_fn(params, batch) -> grads tree must
    differentiate leaves that may be views of a flat buffer (take them
    with ``detach().requires_grad_()``, as ``engine/steps.py`` does).

    tm: one ``LinearTimeModel`` or a per-worker sequence (heterogeneous
    cluster); each is rescaled per phase by the input-size cost ratio.
    jitter / events_for_phase: straggler injection and elastic membership
    (see ``repro_torch.cluster.topology``).
    plane: a ``repro_torch.data.DataPlane`` supplying every worker's
    batches from the canonical per-(phase, worker, step) sample streams;
    when given, the factory's ``data_fn`` slot is ignored (it may be None).
    traced: run each phase through the traced simulator
    (``repro_torch.cluster.trace.simulate_traced``: host-side schedule
    pass + the flat-store replay, one B3 launch per event on the card)
    instead of the event path — same timeline, samples and epoch
    structure; ``trace_chunk`` bounds events per staged chunk and
    ``trace_update`` picks the update form (``"auto"``/``"pallas"``: the
    B3 wrapper; ``"xla"``: its plain version).
    precision: ``"f32"`` (default) or ``"bf16"`` — the traced replay
    carries the bf16 store + f32 master pair (requires ``traced=True``:
    the event path holds no flat store for a shadow).
    device: where the run happens; ``None`` means the card (raises without
    CUDA).  Params must already live there.  On CUDA, TF32 is turned off
    (``repro_torch.device.strict_f32``).

    log_fn, when given, receives one record per phase: the host seconds
    from the phase's start to its first gradient (``stall_s``) and to its
    end with the device synchronised (``wall_s``), and its event count.
    """
    name = "ps_sim"

    def __init__(self, fns_factory: Callable, *, tm, axis: str = "resolution",
                 sync: Any = "asp", staleness: int = 3,
                 momentum: float = 0.9, ref_size: Optional[int] = None,
                 jitter=0.0,
                 events_for_phase: Optional[
                     Callable[[int, Any], Sequence[ClusterEvent]]] = None,
                 plane=None, traced: bool = False, trace_chunk: int = 32,
                 trace_update: str = "auto", precision: str = "f32",
                 device=None, log_fn: Optional[Callable[[dict], None]] = None):
        self._factory = fns_factory
        self._fns_cache: dict = {}
        self.tm = tm
        self.axis = axis
        self.sync: SyncPolicy = as_policy(sync, staleness)
        self.momentum = momentum
        self.ref_size = ref_size
        self.jitter = jitter
        self.events_for_phase = events_for_phase
        self.plane = plane
        self.traced = bool(traced)
        self.trace_chunk = int(trace_chunk)
        self.trace_update = trace_update
        if precision not in ("f32", "bf16"):
            raise ValueError(f"unknown precision {precision!r} "
                             "(expected 'f32' or 'bf16')")
        if precision != "f32" and not self.traced:
            raise ValueError(
                "precision='bf16' requires traced=True: only the traced "
                "executor carries the bf16 store + f32 master pair (the "
                "event path is tree-based f32)")
        self.precision = precision
        self.device = resolve_device(device)
        strict_f32(self.device)
        self.log_fn = log_fn

    def _fns(self, input_size: int):
        if input_size not in self._fns_cache:
            self._fns_cache[input_size] = self._factory(input_size)
        return self._fns_cache[input_size]

    def _scaled_tms(self, input_size: int, ref_size: int):
        tms = self.tm if isinstance(self.tm, (list, tuple)) else [self.tm]
        scaled = [scaled_time_model(t, input_size, ref_size, axis=self.axis)
                  for t in tms]
        return scaled if isinstance(self.tm, (list, tuple)) else scaled[0]

    def run(self, phases: Sequence, params, *, opt_state=None, seed: int = 0,
            ckpt_dir: Optional[str] = None,
            resume: bool = False) -> RunResult:
        params = _as_tree(params)
        for leaf in tree_leaves(params):
            if leaf.device != self.device:
                raise ValueError(f"params live on {leaf.device} but the "
                                 f"backend runs on {self.device}")
        if self.plane is not None:
            self.plane.bind(phases)
        ref_size = self.ref_size or max(p.input_size for p in phases)
        like = {"params": params, "clock": np.zeros((), np.float64),
                "epochs": np.zeros((), np.int64)}
        start, tree = _restore(ckpt_dir, resume, like)
        t_off, epoch_off, resumed = 0.0, 0, None
        if start is not None:
            params = tree["params"]
            t_off = float(tree["clock"])
            epoch_off = int(tree["epochs"])
            resumed = start
        history: List[dict] = []
        phase_recs: List[dict] = []
        for i in range(start or 0, len(phases)):
            phase = phases[i]
            if phase.plan is None:
                raise ValueError("simulator phases need a dual-batch plan "
                                 "(n_small=0 plans model the baseline)")
            tm_sub = self._scaled_tms(phase.input_size, ref_size)
            workers = workers_from_plan(phase.plan, tm_sub,
                                        jitter=self.jitter)
            grad_fn, data_fn, eval_fn = self._fns(phase.input_size)
            feed = None
            if self.plane is not None:
                if self.traced:
                    # trace staging draws the SAME counter-keyed streams
                    # directly (trace.stream_step), no per-event closure
                    feed = self.plane.trace_feed(i, phase, self.device)
                    data_fn = None
                else:
                    data_fn = self.plane.sim_data_fn(i, phase, self.device)
            elif data_fn is None:
                raise ValueError("fns_factory returned data_fn=None; pass "
                                 "plane=DataPlane(...) to supply batches")
            lr_fn = phase.lr_for_epoch or (lambda e, lr=phase.lr: lr)
            events = (self.events_for_phase(i, phase)
                      if self.events_for_phase else ())
            t0 = time.perf_counter()
            first: List[float] = []

            def timed_grad(p, b, _grad=grad_fn):
                if not first:
                    first.append(time.perf_counter())
                return _grad(p, b)
            kw = dict(epochs=max(1, phase.epochs), lr_for_epoch=lr_fn,
                      sync=self.sync, momentum=self.momentum,
                      eval_fn=eval_fn, seed=phase_seed(seed, i),
                      events=events)
            if self.traced:
                res = simulate_traced(params, timed_grad, data_fn, workers,
                                      feed=feed,
                                      scan_chunk=self.trace_chunk,
                                      update=self.trace_update,
                                      precision=self.precision, **kw)
            else:
                res = simulate(params, timed_grad, data_fn, workers, **kw)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            if self.log_fn is not None:
                self.log_fn({"phase": i,
                             "kind": "trace" if self.traced else "event",
                             "events": res.n_pushes,
                             "stall_s": (first[0] if first else t1) - t0,
                             "wall_s": t1 - t0})
            params = res.params
            for rec in res.history:
                history.append({**rec, "phase": i,
                                "epoch": rec["epoch"] + epoch_off,
                                "sim_time": rec["sim_time"] + t_off})
            phase_recs.append(phase_record(
                i, self.name, phase, steps=res.n_pushes, time_s=res.sim_time,
                t0=t_off,
                metrics=res.history[-1] if res.history else {}))
            t_off += res.sim_time
            epoch_off += max(1, phase.epochs)
            if ckpt_dir:
                save_checkpoint(ckpt_dir, i + 1,
                                {"params": params,
                                 "clock": np.float64(t_off),
                                 "epochs": np.int64(epoch_off)})
        return RunResult(self.name, params, None, t_off, history,
                         phase_recs, resumed)


class SpmdBackend:
    """Synchronous engine backend (the paper's speed path).

    Wraps a ``TrainEngine`` + ``batch_fn`` and runs the schedule one phase
    at a time; the engine's step cache persists across phases.  A
    ``DataPlane`` passed as ``batch_fn`` is bound to the full schedule up
    front.  Checkpoints and resume as ``PsSimBackend``'s, holding
    ``params`` and ``opt_state``.
    """
    name = "spmd"

    def __init__(self, engine, batch_fn: Callable):
        self.engine = engine
        self.batch_fn = batch_fn

    def run(self, phases: Sequence, params, *, opt_state=None, seed: int = 0,
            ckpt_dir: Optional[str] = None, resume: bool = False,
            log_every: int = 20,
            log_fn: Optional[Callable[[dict], None]] = None) -> RunResult:
        params = _as_tree(params)
        if hasattr(self.batch_fn, "bind"):
            self.batch_fn.bind(phases)
        if opt_state is None:
            opt_state = self.engine.optimizer.init(params)
        like = {"params": params, "opt_state": opt_state}
        start, tree = _restore(ckpt_dir, resume, like)
        resumed = None
        if start is not None:
            params, opt_state = tree["params"], tree["opt_state"]
            resumed = start
        start = start or 0
        # when every phase runs on the engine's flat store, the store goes
        # from run to run (no tree rebuilt at each boundary to sit beside
        # the caller's); checkpoints save its public tree
        params = self.engine.to_flat(params, phases[start:])
        gstep = sum(p.n_steps for p in phases[:start])
        samples = sum(p.n_steps * p.batch_size * p.input_size
                      for p in phases[:start])
        history: List[dict] = []
        phase_recs: List[dict] = []
        t_total = 0.0
        for i in range(start, len(phases)):
            phase = phases[i]
            t0 = time.time()
            params, opt_state, hist = self.engine.run(
                [phase], params, opt_state, self.batch_fn, seed=seed,
                start_step=gstep, start_samples=samples,
                wall_offset=t_total, log_every=log_every, log_fn=log_fn,
                phase_offset=i)
            dt = time.time() - t0
            for rec in hist:
                history.append({**rec, "phase": i})
            phase_recs.append(phase_record(
                i, self.name, phase, steps=phase.n_steps, time_s=dt,
                t0=t_total,
                metrics={"loss": hist[-1]["loss"]} if hist else {}))
            t_total += dt
            gstep += phase.n_steps
            samples += phase.n_steps * phase.batch_size * phase.input_size
            if ckpt_dir:
                save_checkpoint(ckpt_dir, i + 1,
                                {"params": params, "opt_state": opt_state})
        return RunResult(self.name, _as_tree(params), opt_state, t_total,
                         history, phase_recs, resumed)
