"""Cluster topology: per-worker runtime models and elastic membership (the
port of the reference's ``cluster/topology.py``, pure Python).

Workers are first-class: each carries its own iteration time (from a
per-worker ``LinearTimeModel`` — Tula-style heterogeneous clusters) and an
optional multiplicative jitter sigma (straggler injection, paper §2.4).
``ClusterEvent``s add elastic join/leave so fault and autoscaling scenarios
are expressible without forking the simulator loop.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

from repro_torch.core.time_model import LinearTimeModel


@dataclass(frozen=True)
class WorkerSpec:
    batch_size: int
    data_per_epoch: float    # d_i from the dual-batch plan
    update_factor: float     # model-update factor (1.0 for large-batch)
    iter_time: float         # a*B + b seconds per iteration (Eq. 2)
    jitter: float = 0.0      # lognormal sigma on iter_time (0 = none)

    @property
    def iters_per_epoch(self) -> int:
        return max(1, math.ceil(self.data_per_epoch / self.batch_size))


@dataclass(frozen=True)
class ClusterEvent:
    """Elastic membership event at simulated time ``time``.

    action "join":  ``worker`` (a WorkerSpec) enters the cluster and runs a
                    full allocation starting at ``time``.
    action "leave": worker ``worker_id`` (index into the worker list, joins
                    included in arrival order) departs; it stops pulling
                    work and no longer gates sync or epoch evaluation.
    """
    time: float
    action: str                          # "join" | "leave"
    worker: Optional[WorkerSpec] = None  # join payload
    worker_id: Optional[int] = None      # leave target

    def __post_init__(self):
        if self.action not in ("join", "leave"):
            raise ValueError(f"unknown cluster event action {self.action!r}")
        if self.action == "join" and self.worker is None:
            raise ValueError("join event needs a WorkerSpec")
        if self.action == "leave" and self.worker_id is None:
            raise ValueError("leave event needs a worker_id")


TimeModels = Union[LinearTimeModel, Sequence[LinearTimeModel]]


def _per_worker(value, n: int, what: str) -> list:
    """Broadcast a scalar to n workers, or validate a length-n sequence."""
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f"{what}: got {len(value)} entries for "
                             f"{n} workers")
        return list(value)
    return [value] * n


def workers_from_plan(plan, tm: TimeModels, *,
                      jitter=0.0) -> List[WorkerSpec]:
    """Build WorkerSpecs from a DualBatchPlan.

    ``tm`` is one LinearTimeModel (homogeneous cluster) or a sequence of
    per-worker models, large group first (heterogeneous cluster).  ``jitter``
    broadcasts the same way.
    """
    n = plan.n_workers
    tms = _per_worker(tm, n, "time models")
    jit = _per_worker(jitter, n, "jitter")
    ws = []
    for i in range(plan.n_large):
        ws.append(WorkerSpec(plan.B_L, plan.d_L, 1.0,
                             tms[i].batch_time(plan.B_L), jit[i]))
    for i in range(plan.n_large, n):
        ws.append(WorkerSpec(plan.B_S, plan.d_S, plan.update_factor_small,
                             tms[i].batch_time(plan.B_S), jit[i]))
    return ws
