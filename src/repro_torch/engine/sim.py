"""Phase schedules on the event-driven PS simulator — thin front-end over
``repro_torch.cluster.PsSimBackend`` (the port of the reference's
``engine/sim.py``).

The same ``Phase`` list that drives the engine drives the simulator: each
phase becomes one simulator run with workers from its dual-batch plan
under the phase's input-size-rescaled time model, params carrying across
phases.  ``run_sim`` returns the backend's ``RunResult`` — the full
concatenated cross-phase history (absolute sim-time offsets, cumulative
epoch numbering) plus unified per-phase records.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from repro_torch.cluster.backend import (PsSimBackend, RunResult,
                                         scaled_time_model)
from repro_torch.core.time_model import LinearTimeModel
from repro_torch.engine.phases import Phase

__all__ = ["run_sim", "scaled_time_model"]


def run_sim(phases: Sequence[Phase], init_params, fns_factory: Callable, *,
            tm: LinearTimeModel, axis: str = "resolution",
            sync="asp", momentum: float = 0.9, seed: int = 0,
            ref_size: Optional[int] = None, jitter=0.0,
            ckpt_dir: Optional[str] = None,
            resume: bool = False, plane=None,
            traced: bool = False, device=None) -> RunResult:
    """Run a phase schedule on the PS-sim backend.

    fns_factory(input_size) -> (grad_fn, data_fn, eval_fn) at that size
    (memoized per size by the backend).  ``sync`` takes a ``SyncPolicy``
    or the string spelling.  ``plane`` (a ``repro_torch.data.DataPlane``)
    replaces the factory's data_fn with the canonical per-worker sample
    streams.  ``traced=True`` runs each phase through the traced
    simulator (see ``repro_torch.cluster.trace``).  ``device=None`` means
    the card.  ``ckpt_dir`` saves a checkpoint at every phase boundary,
    and ``resume`` restarts from the latest one there.  Returns the backend ``RunResult`` (``.params``, ``.time``,
    ``.history``, ``.phases``, ``.last``).
    """
    backend = PsSimBackend(fns_factory, tm=tm, axis=axis, sync=sync,
                           momentum=momentum, ref_size=ref_size,
                           jitter=jitter, plane=plane, traced=traced,
                           device=device)
    return backend.run(phases, init_params, seed=seed, ckpt_dir=ckpt_dir,
                       resume=resume)
