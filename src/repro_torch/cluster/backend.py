"""Cluster backends (the port of the reference's ``cluster/backend.py``).

``SpmdBackend`` is the synchronous engine path — the paper's speed path —
run one phase at a time so phase boundaries are observable, with the
reference's unified per-phase history.  The PS simulator backend
(``PsSimBackend``) waits for the PS-sim slice (ROADMAP A7), and
phase-boundary checkpoints for the checkpoint slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

from repro_torch.core.flat import FlatParams


def _as_tree(params):
    """Accept a flat store anywhere a params tree is expected."""
    return params.to_tree() if isinstance(params, FlatParams) else params


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
    time: float = 0.0               # wall s (spmd)
    history: List[dict] = field(default_factory=list)   # concatenated
    phases: List[dict] = field(default_factory=list)    # phase_record()s
    resumed_from: Optional[int] = None   # phase boundary restored, if any

    @property
    def last(self) -> dict:
        return self.history[-1] if self.history else {}


class SpmdBackend:
    """Synchronous engine backend (the paper's speed path).

    Wraps a ``TrainEngine`` + ``batch_fn`` and runs the schedule one phase
    at a time; the engine's step cache persists across phases.  A
    ``DataPlane`` passed as ``batch_fn`` is bound to the full schedule up
    front.
    """
    name = "spmd"

    def __init__(self, engine, batch_fn: Callable):
        self.engine = engine
        self.batch_fn = batch_fn

    def run(self, phases: Sequence, params, *, opt_state=None, seed: int = 0,
            ckpt_dir: Optional[str] = None, resume: bool = False,
            log_every: int = 20,
            log_fn: Optional[Callable[[dict], None]] = None) -> RunResult:
        if ckpt_dir or resume:
            raise NotImplementedError(
                "phase-boundary checkpoints wait for the checkpoint slice "
                "(ROADMAP A9)")
        params = _as_tree(params)
        if hasattr(self.batch_fn, "bind"):
            self.batch_fn.bind(phases)
        if opt_state is None:
            opt_state = self.engine.optimizer.init(params)
        gstep, samples = 0, 0
        history: List[dict] = []
        phase_recs: List[dict] = []
        t_total = 0.0
        for i, phase in enumerate(phases):
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
        return RunResult(self.name, params, opt_state, t_total, history,
                         phase_recs, None)
