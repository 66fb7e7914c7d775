"""Training-time and memory models (paper §3.2, Eq. 2/3; §5.3, Eq. 9).

The paper assumes per-batch time is linear in batch size, t(x) = a·x + b,
validates it by regression on measured batches (Fig. 3/4, Table 4), and uses
the same linear-regression trick for memory, M(B) = P + B·A (Eq. 9, Fig. 13),
to pick the hardware-maximal batch size B_L.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Sequence


def _linreg(xs: Sequence[float], ys: Sequence[float]) -> tuple[float, float]:
    """Least squares y = a*x + b. Returns (a, b)."""
    n = len(xs)
    sx = sum(xs); sy = sum(ys)
    sxx = sum(x * x for x in xs); sxy = sum(x * y for x, y in zip(xs, ys))
    denom = n * sxx - sx * sx
    a = (n * sxy - sx * sy) / denom
    b = (sy - a * sx) / n
    return a, b


@dataclass(frozen=True)
class LinearTimeModel:
    """t_batch(x) = a·x + b  (paper Eq. 2's inner term)."""
    a: float   # seconds per sample
    b: float   # fixed per-batch overhead (launch, sync, framework)

    def batch_time(self, x: float) -> float:
        return self.a * x + self.b

    def epoch_time(self, x: float, d: float) -> float:
        """Eq. 2: t = (a·x + b) · ceil(d/x)."""
        return (self.a * x + self.b) * math.ceil(d / x)

    def epoch_time_approx(self, x: float, d: float) -> float:
        """Eq. 3: t ≈ (a + b/x) · d."""
        return (self.a + self.b / x) * d

    def scaled(self, input_size: float, ref_size: float, *,
               axis: str = "resolution") -> "LinearTimeModel":
        """The model rescaled to another input size: per-sample cost a
        scales with the input cost ratio (r² on images, s on sequences);
        the per-batch overhead b is size-independent (paper §4.2).  This
        is THE size-rescaling rule — the cluster backends, the hybrid
        scheduler and the autotuner's analytic pruning all route through
        it so a schedule is costed identically everywhere."""
        scale = ((input_size / ref_size) ** 2 if axis == "resolution"
                 else input_size / ref_size)
        return LinearTimeModel(a=self.a * scale, b=self.b)

    @staticmethod
    def fit(batch_sizes: Sequence[float],
            batch_times: Sequence[float]) -> "LinearTimeModel":
        a, b = _linreg(batch_sizes, batch_times)
        return LinearTimeModel(a=a, b=b)


def measure_time_model(step_fn: Callable[[int], None],
                       batch_sizes: Sequence[int],
                       repeats: int = 3) -> LinearTimeModel:
    """Fit Eq. 2 by timing real steps (step_fn(B) runs one batch of size B).

    step_fn must block until done (call .block_until_ready()).
    """
    times = []
    for bsz in batch_sizes:
        step_fn(bsz)                       # warmup / compile
        t0 = time.perf_counter()
        for _ in range(repeats):
            step_fn(bsz)
        times.append((time.perf_counter() - t0) / repeats)
    return LinearTimeModel.fit(list(batch_sizes), times)


@dataclass(frozen=True)
class MemoryModel:
    """M(B) = fixed + per_sample·B (paper Eq. 9)."""
    fixed: float        # Σ p_l — params, grads, optimizer state
    per_sample: float   # Σ a_l — activation bytes per sample

    def usage(self, batch: float) -> float:
        return self.fixed + self.per_sample * batch

    def max_batch(self, budget_bytes: float) -> int:
        """Largest B with M(B) <= budget (paper's B_max / our B_L)."""
        if self.per_sample <= 0:
            return 1
        return max(1, int((budget_bytes - self.fixed) / self.per_sample))

    @staticmethod
    def fit(batch_sizes: Sequence[float],
            mem_bytes: Sequence[float]) -> "MemoryModel":
        a, b = _linreg(batch_sizes, mem_bytes)
        return MemoryModel(fixed=b, per_sample=a)

