"""The cluster runtime (the port of the reference's ``repro.cluster``):
one backend interface over the PS simulator and the synchronous engine.

    sync       — pluggable BSP/ASP/SSP ``SyncPolicy`` objects
    topology   — per-worker time models, straggler jitter, elastic events
    simulator  — the event-driven PS loop
    trace      — the traced form: host-side schedule pass emitting a
                 ``SimTrace``, replayed over the flat store with one B3
                 launch per event (``simulate_traced``)
    backend    — ``PsSimBackend`` / ``SpmdBackend`` run the same ``Phase``
                 schedule with unified history

The autotuner's batched replay (``execute_trace_batched``) waits for the
tuning slice (ROADMAP A10).
"""
from repro_torch.cluster.backend import (PsSimBackend, RunResult,
                                         SpmdBackend, phase_record,
                                         phase_seed, scaled_time_model)
from repro_torch.cluster.simulator import SimResult, run_event_loop, simulate
from repro_torch.cluster.sync import ASP, BSP, SSP, SyncPolicy, as_policy
from repro_torch.cluster.topology import (ClusterEvent, WorkerSpec,
                                          workers_from_plan)
from repro_torch.cluster.trace import (SimTrace, execute_trace,
                                       schedule_pass, simulate_traced,
                                       trace_signature)

__all__ = [
    "SyncPolicy", "BSP", "ASP", "SSP", "as_policy",
    "WorkerSpec", "ClusterEvent", "workers_from_plan",
    "SimResult", "simulate", "run_event_loop",
    "SimTrace", "schedule_pass", "execute_trace", "simulate_traced",
    "trace_signature",
    "RunResult", "PsSimBackend", "SpmdBackend",
    "phase_record", "phase_seed", "scaled_time_model",
]
