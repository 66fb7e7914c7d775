"""Hybrid scheme (paper §4.2): cyclic progressive learning x dual-batch.

For every CPL sub-stage, the dual-batch plan is re-solved at that input
size's memory-maximal large batch B_L(size), producing per-sub-stage
(B_S, B_L, d_S, d_L, update factor) — paper Table 7/9 fourth rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from repro_torch.core.dual_batch import DualBatchPlan, solve_plan
from repro_torch.core.progressive import SubStagePlan, adapt_batch, cyclic_schedule
from repro_torch.core.time_model import LinearTimeModel


@dataclass(frozen=True)
class HybridPhase:
    sub: SubStagePlan
    dbl: DualBatchPlan


def _hybrid_schedule(tm: LinearTimeModel, *, stages: Sequence[int],
                     stage_lrs: Sequence[float], sub_sizes: Sequence[int],
                     sub_dropouts: Sequence[float], B_L_ref: int,
                     dataset_size: int, n_workers: int, n_small: int,
                     k: float, factor: str = "ds_over_dl",
                     axis: str = "resolution") -> Tuple[HybridPhase, ...]:
    """Compose CPL and DBL.  B_L_ref is the memory-maximal large batch at the
    LARGEST input size; smaller sub-stage inputs scale it up (paper Table 6:
    B_L = (2330, 1110, 740) for ImageNet resolutions (160, 224, 288)).

    The time model is rescaled per sub-stage via ``LinearTimeModel.scaled``:
    per-sample cost a scales with the input cost (r^2 or s), overhead b is
    size-independent.
    """
    cpl = cyclic_schedule(stages=stages, stage_lrs=stage_lrs,
                          sub_sizes=sub_sizes, sub_dropouts=sub_dropouts,
                          B_ref=B_L_ref, axis=axis)
    ref = max(sub_sizes)
    phases = []
    for sub in cpl:
        tm_sub = tm.scaled(sub.input_size, ref, axis=axis)
        B_L = adapt_batch(B_L_ref, ref, sub.input_size, axis=axis)
        dbl = solve_plan(tm_sub, B_L=B_L, d=dataset_size,
                         n_workers=n_workers, n_small=n_small, k=k,
                         factor=factor)
        phases.append(HybridPhase(sub=sub, dbl=dbl))
    return tuple(phases)


def predicted_total_time(phases: Sequence[HybridPhase],
                         tm: LinearTimeModel, *, axis: str = "resolution",
                         ref_size: Optional[int] = None) -> float:
    """Predicted wall-clock of the whole schedule (per-worker epoch time x
    epochs, using the per-sub-stage rescaled time model)."""
    if ref_size is None:
        ref_size = max(p.sub.input_size for p in phases)
    total = 0.0
    for p in phases:
        tm_sub = tm.scaled(p.sub.input_size, ref_size, axis=axis)
        total += p.sub.epochs * p.dbl.predicted_epoch_time(tm_sub)
    return total
