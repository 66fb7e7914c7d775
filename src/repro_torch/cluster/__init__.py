"""The cluster runtime.  Ported so far: the synchronous ``SpmdBackend``;
the PS simulator (sync, topology, simulator, trace) waits for ROADMAP
A7/A8."""
from repro_torch.cluster.backend import (RunResult, SpmdBackend,
                                         phase_record, phase_seed)

__all__ = ["RunResult", "SpmdBackend", "phase_record", "phase_seed"]
