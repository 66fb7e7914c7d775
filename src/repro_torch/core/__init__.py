"""Core: the paper's contribution as composable modules.

- time_model:      Eq. 2/3 (time) and Eq. 9 (memory) linear models
- dual_batch:      Eq. 4-8 plan solver + model-update factors
- flat:            tree ⇄ flat-buffer codec (the fused hot path's store)
- progressive:     cyclic progressive learning schedules
- hybrid:          CPL x DBL composition
- spmd_dual_batch: the synchronous dual-batch layout
- tree:            jax.tree_util-ordered helpers over dicts/lists of tensors

The event-driven BSP/ASP/SSP simulator lives in ``repro_torch.cluster``;
this package re-exports its core names (lazily — ``repro_torch.cluster``
itself imports ``core.time_model``, so an eager import here would be
circular).
"""
from repro_torch.core.dual_batch import DualBatchPlan, plan_table, solve_plan, update_factor
from repro_torch.core.flat import FlatParams, FlatSpec, flat_spec
from repro_torch.core.hybrid import HybridPhase, predicted_total_time
from repro_torch.core.progressive import SubStagePlan, adapt_batch, cyclic_schedule, total_cost
from repro_torch.core.spmd_dual_batch import SpmdDualBatch, layout_from_plan
from repro_torch.core.time_model import LinearTimeModel, MemoryModel, measure_time_model

_CLUSTER_NAMES = ("SimResult", "WorkerSpec", "simulate", "workers_from_plan")


def __getattr__(name):
    if name in _CLUSTER_NAMES:
        import repro_torch.cluster as cluster
        return getattr(cluster, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DualBatchPlan", "solve_plan", "plan_table", "update_factor",
    "FlatParams", "FlatSpec", "flat_spec",
    "HybridPhase", "predicted_total_time",
    "SimResult", "WorkerSpec", "simulate", "workers_from_plan",
    "SubStagePlan", "adapt_batch", "cyclic_schedule", "total_cost",
    "SpmdDualBatch", "layout_from_plan",
    "LinearTimeModel", "MemoryModel", "measure_time_model",
]
