"""Declarative run facade: ``ScheduleSpec`` + ``RunConfig`` + ``run``
(the port of the reference's ``api.py``).

A ``ScheduleSpec`` is the ONE declarative description of a schedule:
problem geometry (input size, batch, dataset, workers), dual-batch knobs
(n_small, k, update factor), the CPL ladder, LR staging, time model and
seed.  It is a frozen dataclass with an exact JSON roundtrip, equal field
for field — and therefore in ``to_json`` and ``run_key`` — to the
reference's; ``to_phases()`` lowers it to the engine's ``Phase`` list.

``RunConfig`` collects the execution-side knobs.  ``run(spec, config,
...)`` drives either backend: the PS simulator (``backend="ps_sim"``,
event path or traced replay — the paper's accuracy path) or the
synchronous engine (``backend="spmd"``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional, Tuple

from repro_torch.cluster.backend import PsSimBackend, RunResult, SpmdBackend
from repro_torch.core.dual_batch import DualBatchPlan, solve_plan
from repro_torch.core.hybrid import _hybrid_schedule
from repro_torch.core.time_model import LinearTimeModel
from repro_torch.engine.phases import Phase, _phases_from_hybrid, single_phase
from repro_torch.optim import staged_lr

_TUPLE_FIELDS = ("lr_stage_epochs", "lr_stage_lrs", "sub_sizes",
                 "sub_dropouts", "stage_epochs", "stage_lrs")


@dataclass(frozen=True)
class ScheduleSpec:
    """One declarative, serializable schedule — everything that determines
    *what* a run computes (the autotuner's search point).

    ``scheme``: ``"baseline"`` (all-large workers), ``"dbl"`` (dual-batch
    split) or ``"hybrid"`` (CPL ladder x per-sub-stage re-solved DBL).
    ``input_size`` is the largest (reference) input size — the resolution
    or sequence length the time model and ``batch_size`` (the
    memory-maximal B_L) are anchored at; CPL sub-stages scale both.
    ``epochs`` > 0 runs the PS-sim epoch clock; ``n_steps`` > 0 runs SPMD
    steps (the two budgets are exclusive views of the same spec).
    """
    scheme: str = "dbl"                   # baseline | dbl | hybrid
    input_size: int = 32                  # reference size (res / seq len)
    axis: str = "resolution"
    batch_size: int = 64                  # B_L at input_size
    dataset_size: int = 2048
    n_workers: int = 4
    # dual-batch knobs (paper Eq. 4-8)
    n_small: int = 0
    k: float = 1.05
    factor: str = "ds_over_dl"
    # budgets + LR
    epochs: int = 8                       # PS-sim epoch budget
    n_steps: int = 0                      # SPMD step budget (0 = sim mode)
    lr: float = 0.05
    lr_stage_epochs: Tuple[int, ...] = ()   # staged_lr boundaries (dbl)
    lr_stage_lrs: Tuple[float, ...] = ()
    # CPL ladder (hybrid)
    sub_sizes: Tuple[int, ...] = ()       # e.g. (24, 32); low -> high
    sub_dropouts: Tuple[float, ...] = ()
    stage_epochs: Tuple[int, ...] = ()    # epochs per LR stage; () derives
    stage_lrs: Tuple[float, ...] = ()     # () -> (lr, lr/5)
    # time model (Eq. 2: t = a·x + b at input_size) + misc
    tm_a: float = 0.001
    tm_b: float = 0.0246
    sync: str = "asp"                     # bsp | asp | ssp
    dropout: float = 0.0
    micro_steps: int = 0
    seed: int = 0

    # -- derived views --------------------------------------------------
    def time_model(self) -> LinearTimeModel:
        return LinearTimeModel(a=self.tm_a, b=self.tm_b)

    def plan(self) -> DualBatchPlan:
        """The dual-batch plan at the reference size (baseline specs get
        the n_small=0 / k=1 plan, which models the all-large cluster)."""
        n_small = self.n_small if self.scheme != "baseline" else 0
        return solve_plan(self.time_model(), B_L=self.batch_size,
                          d=self.dataset_size, n_workers=self.n_workers,
                          n_small=n_small, k=self.k if n_small else 1.0,
                          factor=self.factor)

    def _stage_layout(self) -> Tuple[Tuple[int, ...], Tuple[float, ...]]:
        """(stage_epochs, stage_lrs) for the hybrid ladder: explicit
        fields win; otherwise the epoch budget splits evenly over the LR
        stages (default two stages at lr, lr/5 — the paper's CIFAR
        staging), remainder to the first stage."""
        lrs = self.stage_lrs or (self.lr, self.lr / 5)
        if self.stage_epochs:
            return tuple(self.stage_epochs), tuple(lrs)
        n = len(lrs)
        base, rem = divmod(self.epochs, n)
        return tuple(base + (1 if i < rem else 0) for i in range(n)), \
            tuple(lrs)

    def to_phases(self) -> Tuple[Phase, ...]:
        """Lower the spec to the engine's ``Phase`` list — the one
        construction path behind every legacy constructor's output."""
        if self.scheme not in ("baseline", "dbl", "hybrid"):
            raise ValueError(f"unknown scheme {self.scheme!r}")
        if self.scheme == "hybrid":
            if not self.sub_sizes:
                raise ValueError("hybrid spec needs sub_sizes (the CPL "
                                 "ladder)")
            if max(self.sub_sizes) != self.input_size:
                raise ValueError(
                    f"input_size={self.input_size} must be the largest CPL "
                    f"sub size (got ladder {self.sub_sizes}) — batch_size "
                    "and the time model are anchored there")
            stages, stage_lrs = self._stage_layout()
            drops = self.sub_dropouts or (self.dropout,) * len(self.sub_sizes)
            hp = _hybrid_schedule(
                self.time_model(), stages=stages, stage_lrs=stage_lrs,
                sub_sizes=self.sub_sizes, sub_dropouts=drops,
                B_L_ref=self.batch_size, dataset_size=self.dataset_size,
                n_workers=self.n_workers, n_small=self.n_small,
                k=self.k if self.n_small else 1.0, factor=self.factor,
                axis=self.axis)
            if self.n_steps:
                return _phases_from_hybrid(
                    hp, total_steps=self.n_steps,
                    global_batch=self.batch_size, axis=self.axis,
                    micro_steps=self.micro_steps)
            return tuple(Phase(input_size=p.sub.input_size, n_steps=0,
                               lr=p.sub.lr, batch_size=p.dbl.B_L,
                               dropout=p.sub.dropout, epochs=p.sub.epochs,
                               plan=p.dbl) for p in hp)
        plan = self.plan()
        if self.n_steps:
            # SPMD step mode: layout solved from the plan (baseline runs
            # unweighted, matching the legacy launch path)
            return single_phase(
                input_size=self.input_size, n_steps=self.n_steps,
                lr=self.lr, batch_size=self.batch_size,
                plan=plan if self.scheme == "dbl" else None,
                dropout=self.dropout, micro_steps=self.micro_steps)
        lr_fn = (staged_lr(list(self.lr_stage_epochs),
                           list(self.lr_stage_lrs))
                 if self.lr_stage_epochs else None)
        return (Phase(input_size=self.input_size, n_steps=0, lr=self.lr,
                      batch_size=self.batch_size, dropout=self.dropout,
                      epochs=self.epochs, plan=plan, lr_for_epoch=lr_fn),)

    # -- serialization ---------------------------------------------------
    def to_json(self) -> str:
        """Canonical JSON (sorted keys) — bit-stable through
        ``from_json`` (floats roundtrip exactly via repr)."""
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ScheduleSpec":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ScheduleSpec fields: {sorted(unknown)}")
        for k in _TUPLE_FIELDS:
            if k in d:
                d[k] = tuple(d[k])
        return cls(**d)

    def replace(self, **kw) -> "ScheduleSpec":
        return replace(self, **kw)

    def run_key(self) -> str:
        """Short content hash of the canonical JSON — the artifact naming
        key: a persisted spec (seed included) fully determines a run, so
        equal keys mean replayable-identical sweeps."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:12]


@dataclass
class RunConfig:
    """Execution-side knobs — how a spec runs, never what it computes.

    The reference's fields.  ``sync=None`` defers to the spec's own policy
    string; a ``SyncPolicy`` object here overrides it (e.g.
    ``SSP(staleness=5)``).  ``precision``: ``"f32"`` or ``"bf16"`` (the
    mixed store); on ``ps_sim`` it requires ``traced=True``, on ``spmd``
    it must match the engine's own (the engine owns its flat-store
    layout).  ``ckpt_dir``/``resume`` are refused until the checkpoint
    slice (ROADMAP A9).  ``log_fn`` receives the engine's step records
    (``spmd``) or one timing record per phase (``ps_sim``).
    """
    backend: str = "ps_sim"              # ps_sim | spmd
    sync: Any = None                     # None -> spec.sync
    staleness: int = 3
    momentum: float = 0.9
    jitter: Any = 0.0
    traced: bool = False                 # traced PS replay (B3 per event)
    trace_chunk: int = 32
    trace_update: str = "auto"
    precision: str = "f32"               # f32 | bf16 (mixed store)
    prefetch: bool = True
    ref_size: Optional[int] = None       # None -> spec.input_size
    events_for_phase: Optional[Callable] = None
    ckpt_dir: Optional[str] = None
    resume: bool = False
    log_every: int = 20
    log_fn: Optional[Callable] = None


def run(spec: ScheduleSpec, config: Optional[RunConfig] = None, *,
        init_params, opt_state=None, fns_factory: Optional[Callable] = None,
        engine=None, plane=None, data=None, device=None) -> RunResult:
    """THE run entrypoint: one spec, one config, either backend.

    ``ps_sim`` (default): needs ``fns_factory(input_size) -> (grad_fn,
    data_fn, eval_fn)``; runs on ``device`` (``None`` means the card,
    raising without CUDA), where ``init_params`` must already live.
    ``spmd``: needs ``engine`` (a ``TrainEngine``, on the card unless it
    was built for the CPU; ``init_params`` on its device).  Batches come
    from ``plane`` or — when ``data`` (a DataPlane source) is given — from
    a plane built here, seeded from ``spec.seed`` and closed when the run
    ends.
    """
    config = config or RunConfig()
    if config.backend not in ("ps_sim", "spmd"):
        raise ValueError(f"unknown backend {config.backend!r}")
    if config.backend == "spmd":
        if engine is None:
            raise ValueError("spmd backend needs engine=TrainEngine(...)")
        if engine.precision != config.precision:
            raise ValueError(
                f"config.precision={config.precision!r} but the engine was "
                f"built with precision={engine.precision!r} — build the "
                "engine at the precision the run asks for")
    elif fns_factory is None:
        raise ValueError("ps_sim backend needs fns_factory(input_size) -> "
                         "(grad_fn, data_fn, eval_fn)")
    phases = spec.to_phases()
    owned = None
    if plane is None and data is not None:
        from repro_torch.data import DataPlane
        plane = owned = DataPlane(data, seed=spec.seed,
                                  prefetch=config.prefetch)
    try:
        if config.backend == "spmd":
            if plane is None:
                raise ValueError("spmd backend needs plane= (or data=) as "
                                 "the batch source")
            kw = {} if opt_state is None else {"opt_state": opt_state}
            return SpmdBackend(engine, plane).run(
                phases, init_params, seed=spec.seed,
                ckpt_dir=config.ckpt_dir, resume=config.resume,
                log_every=config.log_every, log_fn=config.log_fn, **kw)
        backend = PsSimBackend(
            fns_factory, tm=spec.time_model(), axis=spec.axis,
            sync=config.sync if config.sync is not None else spec.sync,
            staleness=config.staleness, momentum=config.momentum,
            ref_size=config.ref_size or spec.input_size,
            jitter=config.jitter, events_for_phase=config.events_for_phase,
            plane=plane, traced=config.traced,
            trace_chunk=config.trace_chunk,
            trace_update=config.trace_update, precision=config.precision,
            device=device, log_fn=config.log_fn)
        return backend.run(phases, init_params, seed=spec.seed,
                           ckpt_dir=config.ckpt_dir, resume=config.resume)
    finally:
        if owned is not None:
            owned.close()


__all__ = ["ScheduleSpec", "RunConfig", "run"]
