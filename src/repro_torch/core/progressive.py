"""Cyclic progressive learning (paper §4.1).

Training is split into LR *stages*; within each stage the input cost axis
(image resolution for CNNs, sequence length for LLMs) cycles low -> high
across *sub-stages*, dropout ramps with it, and the batch size adapts to the
input size so the accelerator stays saturated (paper Table 1/7/9).

Unlike classic progressive resizing, every input size is revisited under
EVERY learning rate — that is the "cyclic" part, and why high-res/long-seq
inputs still receive large-LR updates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple


@dataclass(frozen=True)
class SubStagePlan:
    stage: int
    sub_stage: int
    epochs: int
    lr: float
    input_size: int        # image resolution r or sequence length s
    dropout: float
    batch_size: int        # adapted B for this input size (B_L for hybrid)


def adapt_batch(B_ref: int, ref_size: int, size: int, *,
                axis: str = "resolution",
                mem_fixed_frac: float = 0.0) -> int:
    """Adapt batch size to input size at constant memory (paper §4.1).

    Per-sample memory is  m(size) = m_fix + m_act·act(size)  with
    ``act`` = r² (images) or s (sequence length) and ``mem_fixed_frac``
    (f) the fraction of the per-sample footprint that does NOT scale with
    the input — measured at the reference size: f = m_fix / m(ref).
    Holding the budget M = B_ref·m(ref) fixed and solving M = B·m(size):

        B(size) = B_ref · ratio / (f·ratio + (1 − f)),
        ratio   = act(ref) / act(size)

    f = 0 recovers the pure activation-proportional rule
    B_ref·act(ref)/act(size); f = 1 pins the batch at B_ref.  The paper's
    profiler-measured Table 6 ratios include such a size-independent term,
    which is why the pure rule over-predicts small-resolution batches.
    """
    if axis == "resolution":
        ratio = (ref_size / size) ** 2
    elif axis == "seq_len":
        ratio = ref_size / size
    else:
        raise ValueError(axis)
    f = float(mem_fixed_frac)
    if not 0.0 <= f <= 1.0:
        raise ValueError(f"mem_fixed_frac must be in [0, 1], got {f}")
    return max(1, int(B_ref * ratio / (f * ratio + (1.0 - f))))


def cyclic_schedule(*, stages: Sequence[int], stage_lrs: Sequence[float],
                    sub_sizes: Sequence[int], sub_dropouts: Sequence[float],
                    B_ref: int, axis: str = "resolution"
                    ) -> Tuple[SubStagePlan, ...]:
    """Build the full cyclic-progressive plan (paper Tables 7/9 structure).

    stages: epochs per LR stage (e.g. (80, 40, 20));
    stage_lrs: LR per stage (e.g. (0.2, 0.02, 0.002));
    sub_sizes: input sizes cycled within every stage, low->high;
    B_ref: batch size at the LARGEST input size (the memory-limited one) —
      smaller inputs get proportionally larger batches.
    """
    if len(stages) != len(stage_lrs):
        raise ValueError("stages and stage_lrs length mismatch")
    if len(sub_sizes) != len(sub_dropouts):
        raise ValueError("sub_sizes and sub_dropouts length mismatch")
    ref = max(sub_sizes)
    plans = []
    for si, (ep, lr) in enumerate(zip(stages, stage_lrs)):
        n_sub = len(sub_sizes)
        base = ep // n_sub
        rem = ep - base * n_sub
        for ji, (size, drop) in enumerate(zip(sub_sizes, sub_dropouts)):
            e = base + (1 if ji < rem else 0)
            if e == 0:
                continue
            plans.append(SubStagePlan(
                stage=si, sub_stage=ji, epochs=e, lr=lr, input_size=size,
                dropout=drop,
                batch_size=adapt_batch(B_ref, ref, size, axis=axis)))
    return tuple(plans)


def total_cost(plans: Sequence[SubStagePlan], *, dataset_size: int,
               axis: str = "resolution") -> float:
    """Relative compute cost of a schedule (arbitrary units: samples x
    per-sample cost).  Used to verify the paper's time-reduction claims
    (cost ratio r_small^2/r_large^2 on images -> 0.56 for 24/32 etc.)."""
    cost = 0.0
    for p in plans:
        per_sample = (p.input_size ** 2 if axis == "resolution"
                      else p.input_size)
        cost += p.epochs * dataset_size * per_sample
    return cost
