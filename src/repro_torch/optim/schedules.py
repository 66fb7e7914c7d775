"""LR schedules: the paper's staged decay, warmup (Goyal et al. baseline),
and the cyclic-stage schedule used by cyclic progressive learning."""
from __future__ import annotations

from typing import Callable, Sequence


def staged_lr(stages: Sequence[int], stage_lrs: Sequence[float]
              ) -> Callable[[int], float]:
    """Paper §5.1: LR constant within each stage (e.g. 80/40/20 epochs at
    0.2/0.02/0.002)."""
    bounds = []
    acc = 0
    for e in stages:
        acc += e
        bounds.append(acc)

    def lr(epoch: int) -> float:
        for b, v in zip(bounds, stage_lrs):
            if epoch < b:
                return v
        return stage_lrs[-1]
    return lr


def warmup_staged(stages: Sequence[int], stage_lrs: Sequence[float],
                  warmup_epochs: int = 5) -> Callable[[int], float]:
    """Gradual warmup (Goyal et al., the paper's enhanced baseline):
    start at lr/5 and ramp linearly to stage_lrs[0] over warmup_epochs."""
    base = staged_lr(stages, stage_lrs)

    def lr(epoch: int) -> float:
        if epoch < warmup_epochs:
            lo = stage_lrs[0] / 5.0
            return lo + (stage_lrs[0] - lo) * (epoch + 1) / warmup_epochs
        return base(epoch)
    return lr


def cyclic_stage_lr(phases) -> Callable[[int], float]:
    """LR lookup over a hybrid/CPL phase list (epoch -> that phase's lr)."""
    table = []
    for p in phases:
        lr_val = p.sub.lr if hasattr(p, "sub") else p.lr
        ep = p.sub.epochs if hasattr(p, "sub") else p.epochs
        table.extend([lr_val] * ep)

    def lr(epoch: int) -> float:
        return table[min(epoch, len(table) - 1)]
    return lr
