"""Phase schedules — the engine's unit of work.

A ``Phase`` is one homogeneous stretch of training: fixed input size
(sequence length or image resolution), fixed global batch, fixed LR/dropout,
and an optional dual-batch plan + solved SPMD layout.  The three paper
schemes reduce to phase lists:

  baseline — one phase, no layout
  dbl      — one phase, layout solved from one DualBatchPlan
  hybrid   — one phase per CPL sub-stage, each with its own re-solved plan
             (``hybrid_schedule`` output mapped 1:1 onto phases)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

from repro_torch.core.dual_batch import DualBatchPlan
from repro_torch.core.hybrid import HybridPhase
from repro_torch.core.spmd_dual_batch import SpmdDualBatch, layout_from_plan


@dataclass(frozen=True)
class Phase:
    """One schedulable stretch of training (static per-phase facts only —
    everything the compiled-step cache keys on lives here)."""
    input_size: int                       # seq len (LLM) / resolution (CNN)
    n_steps: int                          # SPMD steps to run in this phase
    lr: float
    batch_size: int                       # global (padded) batch
    dropout: float = 0.0
    epochs: int = 0                       # PS-sim epochs (run_sim path)
    plan: Optional[DualBatchPlan] = None  # None => unweighted baseline
    layout: Optional[SpmdDualBatch] = None
    micro_steps: int = 0                  # >0 => micro-update mode
    # real per-epoch LR schedule for the PS-sim backend (epoch -> lr);
    # None => constant `lr`.  SPMD steps always use `lr` (they have no
    # epoch clock — schedules map onto phases there).
    lr_for_epoch: Optional[Callable[[int], float]] = None


def single_phase(*, input_size: int, n_steps: int, lr: float,
                 batch_size: int, plan: Optional[DualBatchPlan] = None,
                 dropout: float = 0.0, micro_steps: int = 0, epochs: int = 0,
                 lr_for_epoch: Optional[Callable[[int], float]] = None,
                 ) -> Tuple[Phase, ...]:
    """baseline (plan=None) or dual-batch (plan given) as a 1-phase schedule."""
    layout = (layout_from_plan(plan, batch_size)
              if plan is not None and plan.n_small else None)
    return (Phase(input_size=input_size, n_steps=n_steps, lr=lr,
                  batch_size=batch_size, dropout=dropout, epochs=epochs,
                  plan=plan, layout=layout, micro_steps=micro_steps,
                  lr_for_epoch=lr_for_epoch),)


def _phases_from_hybrid(hybrid_phases: Sequence[HybridPhase], *,
                        total_steps: int, global_batch: int,
                        axis: str = "seq_len", micro_steps: int = 0
                        ) -> Tuple[Phase, ...]:
    """Map ``hybrid_schedule`` output 1:1 onto engine phases.

    Steps are split across sub-stages in proportion to their epoch counts;
    the global SPMD batch adapts to the input size at constant memory
    (CPL batch adaptation), and each phase's dual-batch layout is re-solved
    from ITS sub-stage plan via ``layout_from_plan``.
    """
    if not hybrid_phases:
        raise ValueError("empty hybrid schedule")
    total_epochs = sum(p.sub.epochs for p in hybrid_phases) or 1
    ref = max(p.sub.input_size for p in hybrid_phases)
    # largest-remainder-free allocation via cumulative boundaries: sums to
    # exactly total_steps, never goes negative, and when steps are scarce
    # the LATER (larger-input) sub-stages win — CPL's final full-size stage
    # must never be starved by earlier rounding
    cum, bounds = 0, [0]
    for hp in hybrid_phases:
        cum += hp.sub.epochs
        bounds.append(round(max(0, total_steps) * cum / total_epochs))
    out = []
    for i, hp in enumerate(hybrid_phases):
        n = bounds[i + 1] - bounds[i]
        size = hp.sub.input_size
        # exact float cost ratio — integer division (ref // size) silently
        # truncated non-divisible seq ladders (e.g. 384/256 -> 1 instead of
        # 1.5), starving the small-seq sub-stages of their adapted batch
        ratio = ((ref / size) ** 2 if axis == "resolution"
                 else ref / size if size else 1.0)
        nw = hp.dbl.n_workers
        bsz = int(round(global_batch * ratio))
        bsz = max(nw, nw * round(bsz / nw))  # worker-divisible global batch
        layout = (layout_from_plan(hp.dbl, bsz) if hp.dbl.n_small else None)
        out.append(Phase(input_size=size, n_steps=max(0, n), lr=hp.sub.lr,
                         batch_size=bsz, dropout=hp.sub.dropout,
                         epochs=hp.sub.epochs, plan=hp.dbl, layout=layout,
                         micro_steps=micro_steps))
    return tuple(p for p in out if p.n_steps > 0 or p.epochs > 0)
