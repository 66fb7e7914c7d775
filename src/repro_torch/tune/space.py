"""Schedule search space: axes over ``ScheduleSpec`` fields (the port of
the reference's ``tune/space.py``; host-only, the same candidates, labels
and specs).

A ``SearchSpace`` is a base spec plus per-axis value tuples.  ``"star"``
mode (default) varies ONE axis at a time around the base — exactly the
paper's experimental design (Table 3 sweeps the update factor, Table 5
the small-worker count, Table 8 the CPL ladder), so the tables' grid
points fall out as special cases of one candidate set.  ``"product"``
mode takes the full cross product for real searches.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Tuple

from repro_torch.api import ScheduleSpec


def _ladder_label(ladder: Tuple[int, ...]) -> str:
    return "ladder" + "x".join(str(s) for s in ladder) if ladder else "flat"


def _apply_ladder(spec: ScheduleSpec, ladder: Tuple[int, ...]
                  ) -> ScheduleSpec:
    """A ladder value rewrites the scheme: non-empty -> hybrid with that
    CPL ladder (largest rung must be the spec's reference size); empty ->
    the flat scheme (dbl, or baseline when no small group)."""
    if ladder:
        return spec.replace(scheme="hybrid", sub_sizes=tuple(ladder),
                            sub_dropouts=())
    return spec.replace(scheme="dbl" if spec.n_small else "baseline",
                        sub_sizes=(), sub_dropouts=())


@dataclass(frozen=True)
class SearchSpace:
    """Axes over the hybrid-schedule space (empty tuple = keep base).

    ``ladders`` values are CPL sub-size tuples (``()`` = no ladder — the
    flat dbl/baseline scheme); ``cycles`` values are LR-stage counts for
    ladder candidates (2 = the paper's lr, lr/5 staging).
    """
    base: ScheduleSpec
    n_small: Tuple[int, ...] = ()
    k: Tuple[float, ...] = ()
    factor: Tuple[str, ...] = ()
    ladders: Tuple[Tuple[int, ...], ...] = ()
    cycles: Tuple[int, ...] = ()
    n_workers: Tuple[int, ...] = ()
    sync: Tuple[str, ...] = ()
    seeds: Tuple[int, ...] = ()
    mode: str = "star"                  # star | product

    def _axes(self):
        return (("n_small", self.n_small), ("k", self.k),
                ("factor", self.factor), ("ladder", self.ladders),
                ("cycles", self.cycles), ("n_workers", self.n_workers),
                ("sync", self.sync), ("seed", self.seeds))

    def _set(self, spec: ScheduleSpec, axis: str, value) -> ScheduleSpec:
        if axis == "ladder":
            return _apply_ladder(spec, tuple(value))
        if axis == "cycles":
            n = int(value)
            lrs = tuple(spec.lr / 5 ** i for i in range(n))
            return spec.replace(stage_lrs=lrs, stage_epochs=())
        if axis == "n_small":
            # keep scheme consistent: n_small=0 on a flat spec IS baseline
            spec = spec.replace(n_small=int(value))
            if spec.scheme != "hybrid":
                return spec.replace(
                    scheme="dbl" if spec.n_small else "baseline")
            return spec
        return spec.replace(**{axis: value})

    def _label(self, axis: str, value) -> str:
        if axis == "ladder":
            return _ladder_label(tuple(value))
        if axis == "factor":
            return f"f_{value}"
        short = {"n_small": "nS", "k": "k", "cycles": "c",
                 "n_workers": "W", "sync": "", "seed": "s"}[axis]
        return f"{short}{value}"

    def candidates(self) -> List[Tuple[str, ScheduleSpec]]:
        """(label, spec) pairs, deduplicated by spec equality (the base
        always leads).  Star mode: base + one-axis variations; product
        mode: the full cross product, labeled by the axes that differ
        from the base."""
        out: List[Tuple[str, ScheduleSpec]] = [("base", self.base)]
        seen = {self.base}

        def add(label: str, spec: ScheduleSpec):
            if spec not in seen:
                seen.add(spec)
                out.append((label, spec))

        if self.mode == "star":
            for axis, values in self._axes():
                for v in values:
                    add(self._label(axis, v), self._set(self.base, axis, v))
            return out
        if self.mode != "product":
            raise ValueError(f"unknown mode {self.mode!r}")
        axes = [(a, vs) for a, vs in self._axes() if vs]
        for combo in itertools.product(*(vs for _, vs in axes)):
            spec, parts = self.base, []
            for (axis, _), v in zip(axes, combo):
                spec = self._set(spec, axis, v)
                parts.append(self._label(axis, v))
            add("/".join(parts), spec)
        return out


__all__ = ["SearchSpace"]
