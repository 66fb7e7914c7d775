"""The phase-scheduled training engine.

    Phase / single_phase      — the engine's unit of work
    TrainEngine               — step cache + run loop over the flat store
    SpmdBackend / RunResult   — phase-at-a-time driver and its result

The paper schemes are phase lists lowered from ONE declarative
``repro_torch.api.ScheduleSpec`` via ``spec.to_phases()``.
"""
from repro_torch.cluster.backend import RunResult, SpmdBackend
from repro_torch.core.flat import FlatParams, FlatSpec, flat_spec
from repro_torch.engine.engine import StepKey, TrainEngine
from repro_torch.engine.phases import Phase, single_phase
from repro_torch.engine.steps import (make_fused_dbl_step,
                                      make_fused_phase_scan,
                                      make_weighted_step)

__all__ = [
    "Phase", "single_phase", "TrainEngine", "StepKey",
    "SpmdBackend", "RunResult", "FlatParams", "FlatSpec", "flat_spec",
    "make_weighted_step", "make_fused_dbl_step", "make_fused_phase_scan",
]
