"""Dual-batch learning plan solver (paper §3.3–3.4, Eq. 4–8).

Given the time model (a, b), the hardware-maximal batch B_L, total data d,
worker split (n_S small / n_L large) and the extra-training-time ratio k,
derive the per-worker data allocations d_L, d_S and the small batch size B_S
such that both worker groups take exactly k x the all-large-batch epoch time
(Eq. 4/5) — the paper's straggler-free load balance.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.time_model import LinearTimeModel


@dataclass(frozen=True)
class DualBatchPlan:
    k: float
    n_workers: int
    n_small: int
    n_large: int
    B_L: int
    B_S: int
    d: int            # total data
    d_L: float        # per large-batch worker
    d_S: float        # per small-batch worker
    update_factor_small: float
    update_factor_name: str

    @property
    def small_data_fraction(self) -> float:
        return self.n_small * self.d_S / self.d if self.n_small else 0.0

    def predicted_epoch_time(self, tm: LinearTimeModel) -> float:
        """Eq. 4/5 both evaluate to k·(a + b/B_L)·d/n."""
        times = []
        if self.n_large:
            times.append(tm.epoch_time_approx(self.B_L, self.d_L))
        if self.n_small:
            times.append(tm.epoch_time_approx(self.B_S, self.d_S))
        return max(times)


def update_factor(name: str, d_S: float, d_L: float) -> float:
    """Paper §3.4 model-update factors (large-batch factor is always 1)."""
    if name == "ds_over_dl":
        return d_S / d_L
    if name == "sqrt":
        return math.sqrt(d_S / d_L)
    if name == "none":
        return 1.0
    raise ValueError(f"unknown update factor {name!r}")


def solve_plan(tm: LinearTimeModel, *, B_L: int, d: int, n_workers: int,
               n_small: int, k: float,
               factor: str = "ds_over_dl") -> DualBatchPlan:
    """Solve Eq. 4–8 for the dual-batch configuration.

    Eq. 4:  d_L = k·d/n
    Eq. 6:  d = n_L·d_L + n_S·d_S   ->  d_S
    Eq. 8:  B_S = b / ((a + b/B_L)·(d_L/d_S) − a)
    """
    if not (0 <= n_small <= n_workers):
        raise ValueError("n_small out of range")
    n_large = n_workers - n_small
    a, b = tm.a, tm.b
    d_L = k * d / n_workers
    if n_small == 0:
        return DualBatchPlan(k, n_workers, 0, n_large, B_L, 0, d, d_L, 0.0,
                             1.0, factor)
    if n_small == n_workers:
        d_S = d / n_workers              # paper Table 2: n_S = n -> d/n each
    else:
        d_S = (d - n_large * d_L) / n_small
    if d_S <= 0:
        raise ValueError(
            f"k={k} too large for n_small={n_small}: no data left for the "
            f"small-batch workers")
    denom = (a + b / B_L) * (d_L / d_S) - a
    if denom <= 0:
        raise ValueError(
            "Eq. 8 has no positive solution: the requested k cannot slow "
            "the small group enough (increase k or n_small)")
    B_S = b / denom
    B_S_int = max(1, int(round(B_S)))
    f = update_factor(factor, d_S, d_L)
    return DualBatchPlan(k, n_workers, n_small, n_large, B_L, B_S_int, d,
                         d_L, d_S, f, factor)


def plan_table(tm: LinearTimeModel, *, B_L: int, d: int, n_workers: int,
               k: float, factor: str = "ds_over_dl"):
    """Paper Table 2: one plan per n_small in 1..n_workers."""
    return [solve_plan(tm, B_L=B_L, d=d, n_workers=n_workers, n_small=ns,
                       k=k, factor=factor)
            for ns in range(1, n_workers + 1)]
