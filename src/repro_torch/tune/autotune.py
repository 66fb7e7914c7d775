"""The schedule autotuner: analytic pruning + traced validation + Pareto
(the port of the reference's ``tune/autotune.py``).

Three stages over a ``SearchSpace``'s candidates:

  1. **cost**: every candidate is priced analytically — predicted wall
     time from the paper's Eq. 2/3 linear time model (rescaled per CPL
     sub-stage) and total compute cost (samples x per-sample input cost).
     Candidates whose predicted time exceeds ``budget_ratio`` x the
     fastest candidate's are pruned without touching the device — the
     time model is exact about *relative schedule time* (it IS the
     simulator's clock), so time-side pruning is safe; it knows nothing
     about accuracy, which is why pruning is a budget filter, never a
     quality filter.
  2. **validate**: surviving candidates run on the traced simulator.
     Single-phase candidates whose traces share a ``trace_signature``
     (factor / LR / seed variants — identical timelines) replay together
     through ``execute_trace_batched``: one event loop, one staging pass,
     one batched B3 launch an event, C results.  Everything else
     (multi-phase hybrid schedules, distinct timelines) replays through
     the unified ``repro_torch.api.run`` entrypoint with ``traced=True``.
  3. **front**: the time/cost/accuracy Pareto front.  Dominance is
     noise-aware: a candidate dominates another only if it is no worse
     on every objective AND better beyond the noise floor on one
     (``acc_eps`` — accuracy differences inside it are statistical ties
     at this scale; ``rel_eps`` for the time/cost ratios).

Everything is deterministic given the specs' seeds: same search, same
front, same artifact (``TuneResult.run_key``).  The analytic stage is host
arithmetic through the port's copies of the core math, so its
``TuneResult.to_json`` equals the reference's byte for byte.

Where the port differs: ``autotune`` takes ``device`` (``None`` means the
card, as ``api.run`` does), hands it to ``api.run`` and to
``DataPlane.trace_feed``, and refuses initial params that live elsewhere;
the batched path turns TF32 off on the card itself
(``device.strict_f32``), as ``PsSimBackend`` does for the ``api`` path.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Tuple

from repro_torch import api
from repro_torch.api import RunConfig, ScheduleSpec
from repro_torch.cluster.backend import phase_seed
from repro_torch.cluster.topology import workers_from_plan
from repro_torch.cluster.trace import (execute_trace_batched, schedule_pass,
                                       trace_signature)
from repro_torch.core.tree import tree_leaves
from repro_torch.device import resolve_device, strict_f32
from repro_torch.tune.space import SearchSpace


# --------------------------------------------------------------------------
# analytic stage: time + cost from the spec alone
# --------------------------------------------------------------------------
def predicted_schedule_time(spec: ScheduleSpec) -> float:
    """Predicted simulated wall time of the whole schedule: per phase,
    the dual-batch plan's slowest-worker epoch time under the
    size-rescaled time model (Eq. 2/3) x the phase's epochs.  This is
    the same arithmetic the simulator's clock integrates, so the ratio
    between two candidates' predictions matches their simulated times."""
    tm = spec.time_model()
    total = 0.0
    for ph in spec.to_phases():
        tm_sub = tm.scaled(ph.input_size, spec.input_size, axis=spec.axis)
        total += max(1, ph.epochs) * ph.plan.predicted_epoch_time(tm_sub)
    return total


def schedule_cost(spec: ScheduleSpec) -> float:
    """Total compute cost in full-size-epoch equivalents: epochs x
    per-sample input cost summed over phases, divided by one epoch's cost
    at the reference size — a flat E-epoch schedule costs exactly E; CPL
    ladders land below their flat counterpart.  Comparable across
    candidates that share a dataset and reference size (a search space)."""
    per = (lambda s: s ** 2) if spec.axis == "resolution" else (lambda s: s)
    cost = sum(max(1, ph.epochs) * per(ph.input_size)
               for ph in spec.to_phases())
    return cost / per(spec.input_size)


# --------------------------------------------------------------------------
# candidates + Pareto front
# --------------------------------------------------------------------------
@dataclass
class Candidate:
    """One search point with its analytic and (if validated) simulated
    metrics."""
    label: str
    spec: ScheduleSpec
    predicted_time: float = 0.0
    cost: float = 0.0
    pruned: bool = False
    sim_time: Optional[float] = None
    accuracy: Optional[float] = None
    test_loss: Optional[float] = None
    replay: str = ""                    # "batched:<group>" | "api" | ""

    @property
    def validated(self) -> bool:
        return self.accuracy is not None

    def objectives(self) -> Tuple[float, float, float]:
        """(time, cost, accuracy) — time from the simulator when
        validated, else the analytic prediction."""
        t = self.sim_time if self.sim_time is not None \
            else self.predicted_time
        return (t, self.cost, self.accuracy if self.accuracy is not None
                else float("-inf"))


def dominates(a: Tuple[float, float, float], b: Tuple[float, float, float],
              *, acc_eps: float = 0.03, rel_eps: float = 0.02) -> bool:
    """a dominates b: no worse on time, cost AND accuracy, and better
    beyond the noise floor on at least one.  Accuracy inside ``acc_eps``
    (and time/cost within ``rel_eps`` relative) are ties — a candidate
    never dominates on noise."""
    ta, ca, aa = a
    tb, cb, ab = b
    if ta > tb or ca > cb or aa < ab:
        return False
    return (ta < tb * (1.0 - rel_eps) or ca < cb * (1.0 - rel_eps)
            or aa > ab + acc_eps)


def pareto_front(cands: Sequence[Candidate], *, acc_eps: float = 0.03,
                 rel_eps: float = 0.02) -> List[int]:
    """Indices of the non-dominated validated candidates (input order)."""
    objs = [(i, c.objectives()) for i, c in enumerate(cands)
            if c.validated and not c.pruned]
    front = []
    for i, oi in objs:
        if not any(dominates(oj, oi, acc_eps=acc_eps, rel_eps=rel_eps)
                   for j, oj in objs if j != i):
            front.append(i)
    return front


@dataclass
class TuneResult:
    """The whole search, replayable: every candidate (spec + metrics),
    the front, and the knobs that shaped them."""
    candidates: List[Candidate]
    front: List[int] = field(default_factory=list)
    acc_eps: float = 0.03
    rel_eps: float = 0.02

    @property
    def front_labels(self) -> List[str]:
        return [self.candidates[i].label for i in self.front]

    def best(self, objective: str = "accuracy") -> Candidate:
        key = {"accuracy": lambda c: c.objectives()[2],
               "time": lambda c: -c.objectives()[0],
               "cost": lambda c: -c.objectives()[1]}[objective]
        return max((self.candidates[i] for i in self.front), key=key)

    def run_key(self) -> str:
        """Content hash over every candidate spec's canonical JSON — the
        sweep-artifact key (specs carry their seeds, so equal keys mean
        bit-replayable searches)."""
        h = hashlib.sha256()
        for c in self.candidates:
            h.update(c.spec.to_json().encode())
        return h.hexdigest()[:12]

    def to_json(self) -> str:
        return json.dumps({
            "run_key": self.run_key(),
            "acc_eps": self.acc_eps, "rel_eps": self.rel_eps,
            "front": self.front,
            "candidates": [{
                "label": c.label, "spec": json.loads(c.spec.to_json()),
                "predicted_time": c.predicted_time, "cost": c.cost,
                "pruned": c.pruned, "sim_time": c.sim_time,
                "accuracy": c.accuracy, "test_loss": c.test_loss,
                "replay": c.replay, "in_front": i in self.front,
            } for i, c in enumerate(self.candidates)],
        }, indent=1, sort_keys=True)

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path


# --------------------------------------------------------------------------
# the problem contract + the driver
# --------------------------------------------------------------------------
@dataclass
class TuneProblem:
    """What the autotuner needs from a training problem, keyed by seed:

      init_for(seed)            -> initial params tree, on the device
                                   the search runs on
      fns_for(seed, input_size) -> (grad_fn, data_fn, eval_fn); grad_fn
                                   must be seed-independent (one
                                   architecture — candidates that share a
                                   timeline also share its replay, which
                                   calls the first candidate's grad_fn)
      plane_for(seed)           -> DataPlane over the seed's dataset
    """
    init_for: Callable[[int], Any]
    fns_for: Callable[[int, int], tuple]
    plane_for: Callable[[int], Any]


def _on_device(params, device, label: str):
    for leaf in tree_leaves(params):
        if leaf.device != device:
            raise ValueError(f"{label}: init_for gave params on "
                             f"{leaf.device}, but the search runs on "
                             f"{device}")
    return params


def _validate_batched(group: List[Candidate], problem: TuneProblem,
                      traces, *, momentum: float, trace_chunk: int,
                      prefetch: bool, device) -> None:
    """Replay one same-signature candidate group as a single stacked
    run on ``device`` (TF32 off on the card).  Same-seed groups share ONE
    feed (their sample streams are identical); mixed seeds stage
    per-candidate feeds."""
    strict_f32(device)
    size = group[0].spec.input_size
    grad_fn, _, _ = problem.fns_for(group[0].spec.seed, size)
    phases = [c.spec.to_phases()[0] for c in group]
    inits = [_on_device(problem.init_for(c.spec.seed), device, c.label)
             for c in group]
    eval_fns = [problem.fns_for(c.spec.seed, size)[2] for c in group]
    seeds = [c.spec.seed for c in group]
    feed = feeds = None
    if len(set(seeds)) == 1:
        feed = problem.plane_for(seeds[0]).trace_feed(
            0, phases[0], device, prefetch=prefetch)
    else:
        feeds = [problem.plane_for(s).trace_feed(0, p, device,
                                                 prefetch=prefetch)
                 for s, p in zip(seeds, phases)]
    results = execute_trace_batched(
        inits, grad_fn, traces, feed=feed, feeds=feeds,
        momentum=momentum, eval_fns=eval_fns, scan_chunk=trace_chunk,
        prefetch=prefetch)
    for c, res in zip(group, results):
        last = res.history[-1] if res.history else {}
        c.sim_time = res.sim_time
        c.accuracy = last.get("test_acc")
        c.test_loss = last.get("test_loss")


def _validate_api(cand: Candidate, problem: TuneProblem, *,
                  config: RunConfig, device) -> None:
    """Replay one candidate through the unified entrypoint on ``device``
    (the path for multi-phase hybrids and single-member groups)."""
    spec = cand.spec
    res = api.run(spec, config, init_params=problem.init_for(spec.seed),
                  fns_factory=lambda sz: problem.fns_for(spec.seed, sz),
                  plane=problem.plane_for(spec.seed), device=device)
    # hybrid history ends at the last sub-stage's eval; re-evaluate at the
    # reference size so every candidate's accuracy is comparable
    last = dict(res.last)
    if spec.scheme == "hybrid":
        _, _, eval_fn = problem.fns_for(spec.seed, spec.input_size)
        last.update(eval_fn(res.params))
    cand.sim_time = res.time
    cand.accuracy = last.get("test_acc")
    cand.test_loss = last.get("test_loss")


def _single_phase_trace(cand: Candidate, *, staleness: int = 3):
    """The candidate's one-phase ``SimTrace`` (None for multi-phase
    schedules — those validate through the backend loop)."""
    phases = cand.spec.to_phases()
    if len(phases) != 1:
        return None
    ph = phases[0]
    spec = cand.spec
    workers = workers_from_plan(
        ph.plan, spec.time_model().scaled(ph.input_size, spec.input_size,
                                          axis=spec.axis))
    lr_fn = ph.lr_for_epoch or (lambda e, lr=ph.lr: lr)
    return schedule_pass(workers, epochs=max(1, ph.epochs),
                         lr_for_epoch=lr_fn, sync=spec.sync,
                         staleness=staleness, seed=phase_seed(spec.seed, 0))


def autotune(space, problem: TuneProblem, *,
             config: Optional[RunConfig] = None,
             budget_ratio: Optional[float] = None,
             replay: str = "trace", batch_replay: bool = True,
             validate: bool = True,
             acc_eps: float = 0.03, rel_eps: float = 0.02,
             log: Optional[Callable[[str], None]] = None,
             device=None) -> TuneResult:
    """Search ``space`` (a ``SearchSpace``, or an explicit list of
    ``(label, spec)`` pairs — e.g. the union of several table spaces'
    candidates): price every candidate analytically, prune to the time
    budget, validate survivors on the simulator (batched where timelines
    coincide), return the Pareto front over (time, cost, accuracy).

    ``budget_ratio``: prune candidates predicted slower than this multiple
    of the fastest candidate (None = keep all).  ``replay``: ``"trace"``
    (default) validates on the traced simulator (``simulate_traced``, one
    B3 launch an event) — the only path with batched candidate replay;
    ``"event"`` validates on the event-driven path.  Both paths replay the
    same timeline/samples.
    ``validate=False`` stops after the analytic stage (pure time/cost
    ranking — no accuracies, no front).  ``config`` seeds the execution
    knobs for the ``api.run`` replays.  ``device``: where the validation
    runs (``None`` means the card, raising without CUDA; the analytic
    stage never touches it); ``problem.init_for`` must give params there.
    """
    say = log or (lambda s: None)
    if replay not in ("trace", "event"):
        raise ValueError(f"unknown replay mode {replay!r}")
    config = dataclasses.replace(config or RunConfig(),
                                 traced=(replay == "trace"))
    pairs = space.candidates() if isinstance(space, SearchSpace) else space
    cands = [Candidate(label=lb, spec=sp,
                       predicted_time=predicted_schedule_time(sp),
                       cost=schedule_cost(sp))
             for lb, sp in pairs]
    if budget_ratio is not None and cands:
        floor = min(c.predicted_time for c in cands)
        for c in cands:
            c.pruned = c.predicted_time > budget_ratio * floor
        say(f"pruned {sum(c.pruned for c in cands)}/{len(cands)} "
            f"candidates over {budget_ratio:.2f}x the fastest "
            f"predicted time")
    if not validate:
        return TuneResult(cands, [], acc_eps, rel_eps)
    device = resolve_device(device)

    # group single-phase survivors by trace signature for batched replay
    groups: dict = {}
    solo: List[Candidate] = []
    for c in cands:
        if c.pruned:
            continue
        tr = (_single_phase_trace(c, staleness=config.staleness)
              if batch_replay and replay == "trace" else None)
        if tr is None:
            solo.append(c)
            continue
        groups.setdefault(trace_signature(tr), []).append((c, tr))
    for sig, members in groups.items():
        group = [c for c, _ in members]
        if len(group) == 1:
            solo.append(group[0])
            continue
        say(f"batched replay: {len(group)} candidates share one "
            f"timeline ({', '.join(c.label for c in group)})")
        for c in group:
            c.replay = f"batched:{len(group)}"
        _validate_batched(group, problem,
                          [tr for _, tr in members],
                          momentum=config.momentum,
                          trace_chunk=config.trace_chunk,
                          prefetch=config.prefetch, device=device)
    for c in solo:
        say(f"replaying {c.label} via api.run")
        c.replay = "api"
        _validate_api(c, problem, config=config, device=device)
    front = pareto_front(cands, acc_eps=acc_eps, rel_eps=rel_eps)
    return TuneResult(cands, front, acc_eps, rel_eps)


__all__ = ["Candidate", "TuneProblem", "TuneResult", "autotune",
           "dominates", "pareto_front", "predicted_schedule_time",
           "schedule_cost"]
