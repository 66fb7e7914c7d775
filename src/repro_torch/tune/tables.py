"""The paper's experiment tables as search spaces (the port of the
reference's ``tune/tables.py``).

Each builder returns a ``SearchSpace`` whose candidate set IS the table's
grid: the table's pinned values are applied onto a base spec, the table's
swept variable becomes the one axis.  Benchmarks union several tables'
candidates into ONE ``autotune`` search — the tables are slices of one
search, not separate codepaths.

Defaults mirror the repo's benchmark problem (synthetic CIFAR-shaped
data, 2048 train samples, B_L=64, 4 workers, the measured
``LinearTimeModel(a=0.001, b=0.0246)``); pass ``base=`` to re-target a
table's grid at another problem (e.g. the tiny-LM sweep workload of the
reference's ``benchmarks/autotune_pareto.py``, or the width-8 ResNet of
``chip_smoke.py``'s card-vs-CPU search).
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.api import ScheduleSpec
from repro_torch.tune.space import SearchSpace

# the benchmark problem's constants (benchmarks/common.py)
_BASE = dict(input_size=32, batch_size=64, dataset_size=2048, n_workers=4,
             tm_a=0.001, tm_b=0.0246, lr=0.05, sync="asp")


def base_spec(*, epochs: int = 8, n_small: int = 3, k: float = 1.05,
              factor: str = "ds_over_dl", seed: int = 0,
              **overrides) -> ScheduleSpec:
    """The shared benchmark base: DBL at the repo's problem constants,
    with the benchmarks' 2-stage LR decay (lr until 3E/4, then lr/5)."""
    epochs = int(epochs)
    cfg = dict(_BASE, scheme="dbl", epochs=epochs, n_small=n_small, k=k,
               factor=factor, seed=seed,
               lr_stage_epochs=(epochs * 3 // 4, epochs),
               lr_stage_lrs=(_BASE["lr"], _BASE["lr"] / 5))
    cfg.update(overrides)
    return ScheduleSpec(**cfg)


def table3_space(*, epochs: int = 8, seed: int = 0,
                 base: Optional[ScheduleSpec] = None) -> SearchSpace:
    """Table 3 — model-update factor ablation at n_small=3, k=1.1: the
    factor axis sweeps ds/dl vs sqrt(ds/dl) vs none."""
    base = base or base_spec(epochs=epochs, seed=seed)
    return SearchSpace(
        base=base.replace(scheme="dbl", n_small=3, k=1.1,
                          factor="ds_over_dl"),
        factor=("sqrt", "none"))


def table5_space(*, epochs: int = 6, seed: int = 0,
                 base: Optional[ScheduleSpec] = None) -> SearchSpace:
    """Table 5 — small-worker-count sweep at k=1.05: n_small 0..4 (0 is
    the all-large baseline)."""
    base = base or base_spec(epochs=epochs, seed=seed)
    return SearchSpace(
        base=base.replace(scheme="dbl", n_small=3, k=1.05),
        n_small=(0, 1, 2, 4))


def table8_space(*, epochs: int = 16, seed: int = 0,
                 ladder: Tuple[int, ...] = (24, 32),
                 base: Optional[ScheduleSpec] = None) -> SearchSpace:
    """Table 8 — hybrid CPL+DBL vs flat DBL at n_small=3, k=1.05: the
    ladder axis adds the CPL resolution-ladder candidate (the ladder's
    top rung must be the base's reference size)."""
    base = base or base_spec(epochs=epochs, seed=seed)
    return SearchSpace(
        base=base.replace(scheme="dbl", n_small=3, k=1.05),
        ladders=(tuple(ladder),))


def union_candidates(*spaces: SearchSpace):
    """One candidate list covering several spaces' grids (dedup by spec;
    first occurrence keeps its label) — THE way to run multiple tables as
    a single ``autotune`` search."""
    out, seen = [], set()
    for sp in spaces:
        for label, spec in sp.candidates():
            if spec not in seen:
                seen.add(spec)
                out.append((label, spec))
    return out


def combined_space(*, epochs: int = 6, seed: int = 0,
                   extra_k: tuple = (1.1, 1.5)) -> SearchSpace:
    """One star search whose candidates cover Table 3 (factor axis),
    Table 5 (n_small axis) and Table 8 (ladder axis) grid points, plus a
    k axis (the 1.5 point exists to be budget-pruned — it demonstrates
    the analytic filter without paying for a doomed run)."""
    return SearchSpace(
        base=base_spec(epochs=epochs, n_small=3, k=1.05, seed=seed),
        n_small=(0, 1, 2, 4),
        factor=("sqrt", "none"),
        k=tuple(extra_k),
        ladders=((24, 32),))


__all__ = ["base_spec", "combined_space", "table3_space", "table5_space",
           "table8_space", "union_candidates"]
