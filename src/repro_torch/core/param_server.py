"""Compatibility shim, as in the reference — the event-driven PS simulator
lives in ``repro_torch.cluster`` (sync policies in ``cluster.sync``,
worker topology in ``cluster.topology``, the event loop in
``cluster.simulator``, the schedule entry point in
``cluster.backend.PsSimBackend``).  Import from there."""
from repro_torch.cluster.simulator import SimResult, simulate
from repro_torch.cluster.sync import ASP, BSP, SSP, SyncPolicy, as_policy
from repro_torch.cluster.topology import (ClusterEvent, WorkerSpec,
                                          workers_from_plan)

__all__ = [
    "SimResult", "simulate", "WorkerSpec", "ClusterEvent",
    "workers_from_plan", "SyncPolicy", "BSP", "ASP", "SSP", "as_policy",
]
