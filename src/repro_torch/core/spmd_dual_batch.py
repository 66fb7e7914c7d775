"""Synchronous dual-batch layout (the reference's DESIGN.md §3/§4).

The paper's load balance (Eq. 4–8) already equalizes group epoch times, so
dual-batch runs as a *synchronous* step: the global padded batch carries
per-example weights

    w_ij = factor(group_i) * valid_ij

(large group: factor 1, all valid; small group: model-update factor, first
B_S-of-B_L rows valid), and the global update is the weighted mean of
per-example gradients — the paper's contribution-scaled merge.

An optional *micro-update* mode recovers the higher small-batch update
frequency of ASP: the small group takes ``micro_steps`` sequential local
SGD steps inside one global step before the factor-weighted merge.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from repro_torch.core.dual_batch import DualBatchPlan

if TYPE_CHECKING:        # repro_torch.optim imports this package
    from repro_torch.optim import Optimizer


@functools.lru_cache(maxsize=256)
def _layout_weights(layout: "SpmdDualBatch") -> torch.Tensor:
    """Per-example weight vector, built host-side and cached on the frozen
    layout — schedules that revisit a layout (cyclic CPL) reuse one
    tensor.  It lives on the CPU; the caller moves it to its device."""
    pw = layout.per_worker
    w = np.ones((layout.n_workers, pw), np.float32)
    for i in range(layout.n_workers - layout.n_small, layout.n_workers):
        w[i] = np.where(np.arange(pw) < layout.small_valid,
                        layout.factor_small, 0.0)
    return torch.from_numpy(w.reshape(-1))


@dataclass(frozen=True)
class SpmdDualBatch:
    """Static layout of the dual-batch global batch.

    The global (padded) batch has ``global_batch`` examples split into
    n_workers equal worker-rows of ``per_worker`` examples; the last
    ``n_small`` workers are the small-batch group, of whose rows only the
    first ``small_valid`` are live.
    """
    global_batch: int
    n_workers: int
    n_small: int
    small_valid: int          # valid rows per small worker (from B_S/B_L)
    factor_small: float

    @property
    def per_worker(self) -> int:
        return self.global_batch // self.n_workers

    def weights(self) -> torch.Tensor:
        """(global_batch,) f32 per-example weights (0 = padding), cached
        on the frozen layout as a CPU tensor (do not write to it)."""
        return _layout_weights(self)

    @property
    def effective_examples(self) -> float:
        pw = self.per_worker
        return (self.n_workers - self.n_small) * pw \
            + self.n_small * self.small_valid


def layout_from_plan(plan: DualBatchPlan, global_batch: int) -> SpmdDualBatch:
    """Map a paper DualBatchPlan onto the synchronous global batch.

    Each worker-row is padded to B_L-equivalent width; the small group's
    valid fraction is B_S / B_L.
    """
    pw = global_batch // plan.n_workers
    frac = plan.B_S / plan.B_L if plan.n_small else 0.0
    small_valid = max(1, int(round(pw * frac))) if plan.n_small else 0
    return SpmdDualBatch(global_batch=global_batch,
                         n_workers=plan.n_workers, n_small=plan.n_small,
                         small_valid=small_valid,
                         factor_small=plan.update_factor_small)


def make_train_step(cfg, optimizer: Optimizer, *,
                    layout: Optional[SpmdDualBatch] = None,
                    drop_rate: float = 0.0):
    """The weighted train step (canonical implementation:
    ``repro_torch.engine.steps.make_weighted_step``).

    step(params, opt_state, batch, lr, rng) -> (params, opt_state, metrics)
    batch: {"tokens","labels"[,...]} — weights are attached from `layout`
    (or taken from batch["weight"] when given explicitly).
    """
    from repro_torch.engine.steps import make_weighted_step
    return make_weighted_step(cfg, optimizer, layout=layout,
                              drop_rate=drop_rate)


def make_micro_train_step(cfg, optimizer: Optimizer, *,
                          layout: SpmdDualBatch, micro_steps: int = 2,
                          drop_rate: float = 0.0):
    """Micro-update mode — canonical implementation:
    ``repro_torch.engine.steps.make_micro_step``."""
    from repro_torch.engine.steps import make_micro_step
    return make_micro_step(cfg, optimizer, layout=layout,
                           micro_steps=micro_steps, drop_rate=drop_rate)
