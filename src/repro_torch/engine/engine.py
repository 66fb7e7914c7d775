"""The phase-scheduled training engine (the port of the reference's
``engine/engine.py``).

One engine drives the paper schemes (baseline / dual-batch / hybrid) from
a list of ``Phase``s:

  * a step cache keyed on ``StepKey`` — phases that share a shape/layout
    reuse the same step closure across the schedule (the cyclic part of
    CPL revisits sizes under every LR stage);
  * the fused server update on the SGD dual-batch hot path, run over the
    FLAT parameter store (``repro_torch.core.flat``): per step one backward
    of the merged loss and one ``dbl_apply_flat2d`` launch, in place on a
    ``(params, velocity)`` flat carry that consecutive fused phases share
    (``scan_loop=False`` takes the step-at-a-time ``dbl_merge_flat2d``
    path instead, ``fused_merge=False`` the plain unfused update);
  * **DataPlane feed** — when ``batch_fn`` is a ``DataPlane``, chunks
    arrive through its double-buffered ``scan_feed`` (the next chunk
    stacked into pinned memory and copied on a side stream while the
    current one trains);
  * ``stall_log`` — each phase boundary's time to its first step (step
    construction plus waiting for the first chunk of data).

PyTorch runs eagerly, so there is nothing to compile ahead:
``overlap_compile`` is accepted and inert until the CUDA-graph slice
(ROADMAP A15), and a ``mesh`` raises until the multi-GPU slice.

Numerics: building an engine for CUDA turns TF32 off process-wide
(``repro_torch.device.strict_f32``), because cuDNN runs f32 convolutions
in TF32 by default; the engine's contract is f32 math, as the
reference's.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.flat import FlatSpec, flat_spec
from repro_torch.core.tree import tree_leaves
from repro_torch.device import resolve_device, strict_f32
from repro_torch.engine.phases import Phase
from repro_torch.engine.steps import (make_fused_dbl_step,
                                      make_fused_phase_scan,
                                      make_weighted_step)
from repro_torch.optim import Optimizer


@dataclass(frozen=True)
class StepKey:
    input_size: int
    batch_size: int
    layout: object            # SpmdDualBatch or None (frozen -> hashable)
    micro_steps: int
    kind: str                 # "weighted" | "micro" | "fused"
    drop_rate: float          # per-phase dropout (baked into the step)


def _drop_gen(device: torch.device, seed: int, gstep: int):
    """Per-step dropout generator keyed on (seed, global step)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(gstep)) % 2**63)
    return g


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


class TrainEngine:
    """Phase-scheduled trainer.

    fused_merge: "auto" (fused server update whenever the phase has a
      dual-batch layout AND the engine was built for the plain-SGD server
      update), True (force), False (plain unfused per-leaf update).
    sgd_server: mark the optimizer as the paper's plain-SGD server update
      so dual-batch phases take the fused kernel path (the optimizer's own
      update is bypassed there; its state passes through untouched unless
      ``server_momentum`` folds it into the kernel).
    scan_loop: "auto"/True (fused phases run chunk-wise on the flat store
      with ``dbl_apply_flat2d``) or False (step-at-a-time loop; fused
      phases use ``dbl_merge_flat2d``).
    scan_chunk: steps per chunk (bounds staged batch memory; the loss is
      read back once per chunk).
    server_momentum: fold PS-server momentum into the fused kernel pass
      (requires an opt_state with a params-shaped ``"v"`` tree, e.g.
      ``sgd_momentum``; the updated velocity is written back to it).
      The constructor rejects configurations that would bypass the fused
      scan path (``scan_loop=False``, ``fused_merge=False``, a mesh).
    overlap_compile: accepted for the reference's signature; inert (eager
      PyTorch compiles nothing ahead) until the CUDA-graph slice.
    precision: ``"f32"`` or ``"bf16"`` (bf16 flat store + f32 master,
      both written by the kernel's one launch); fenced like
      ``server_momentum``.
    device: where the engine runs; ``None`` means ``"cuda"`` (raises when
      CUDA is absent).  Params and opt_state must already live there.
    """

    def __init__(self, cfg, optimizer: Optimizer, *,
                 fused_merge="auto", sgd_server: bool = False,
                 drop_rate: float = 0.0, mesh=None,
                 scan_loop="auto", scan_chunk: int = 32,
                 server_momentum: float = 0.0,
                 overlap_compile: bool = True,
                 precision: str = "f32", device=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh runs wait for the multi-GPU slice (ROADMAP A11)")
        self.cfg = cfg
        self.optimizer = optimizer
        self.fused_merge = fused_merge
        self.sgd_server = sgd_server
        self.drop_rate = drop_rate
        self.mesh = mesh
        self.scan_loop = scan_loop
        self.scan_chunk = int(scan_chunk)
        self.server_momentum = float(server_momentum)
        self.overlap_compile = bool(overlap_compile)
        if precision not in ("f32", "bf16"):
            raise ValueError(f"unknown precision {precision!r} "
                             "(expected 'f32' or 'bf16')")
        self.precision = precision
        if self.server_momentum > 0 and (scan_loop is False
                                         or fused_merge is False):
            # the velocity lives in the scan path's kernel sweep; the
            # per-step loop would silently train plain SGD instead
            raise ValueError(
                "server_momentum requires the fused scan path "
                "(scan_loop enabled, fused_merge on, no mesh)")
        if precision != "f32" and (scan_loop is False
                                   or fused_merge is False):
            raise ValueError(
                "precision='bf16' requires the fused scan path "
                "(scan_loop enabled, fused_merge on, no mesh)")
        self.device = resolve_device(device)
        strict_f32(self.device)
        self._cache: dict = {}
        self._phase_cache: dict = {}
        self.stall_log: list = []

    # ------------------------------------------------------------------
    @property
    def _mixed(self) -> bool:
        return self.precision != "f32"

    def _param_spec(self, params) -> FlatSpec:
        return (flat_spec(params, torch.bfloat16) if self._mixed
                else flat_spec(params))

    def _kind_for(self, phase: Phase) -> str:
        if phase.micro_steps and phase.layout is not None:
            return "micro"
        if phase.layout is not None and phase.layout.n_small \
                and phase.layout.small_valid \
                and (self.sgd_server or self.fused_merge is True):
            return "fused"
        return "weighted"

    def _use_scan(self, kind: str) -> bool:
        """Run the phase chunk-wise on the flat store?  Only the fused
        path; the unfused fallback keeps the per-step loop."""
        if kind != "fused":
            return False
        return self.fused_merge is not False and self.scan_loop is not False

    def _drop_rate_for(self, phase: Phase) -> float:
        """Per-phase dropout (CPL sub-stage schedule) wins over the engine
        default."""
        return phase.dropout if phase.dropout > 0 else self.drop_rate

    def _step_key(self, phase: Phase) -> StepKey:
        return StepKey(phase.input_size, phase.batch_size, phase.layout,
                       phase.micro_steps, self._kind_for(phase),
                       self._drop_rate_for(phase))

    def step_fn(self, phase: Phase):
        """(step, cached) for this phase's per-step loop."""
        key = self._step_key(phase)
        if key in self._cache:
            return self._cache[key], True
        if key.kind == "micro":
            raise NotImplementedError(
                "micro-update steps are LM-only and wait for the LM slice "
                "(ROADMAP A12)")
        if key.kind == "fused":
            fn = make_fused_dbl_step(self.cfg, key.layout,
                                     drop_rate=key.drop_rate,
                                     fused=self.fused_merge is not False)
        else:
            fn = make_weighted_step(self.cfg, self.optimizer,
                                    layout=key.layout,
                                    drop_rate=key.drop_rate)
        self._cache[key] = fn
        return fn, False

    def phase_fn(self, phase: Phase, spec: FlatSpec):
        """(chunk fn, cached) for a fused phase, cached on the step key +
        lr + codec spec."""
        ck = (self._step_key(phase), float(phase.lr), id(spec))
        if ck in self._phase_cache:
            return self._phase_cache[ck], True
        fn = make_fused_phase_scan(self.cfg, phase.layout, spec,
                                   lr=phase.lr,
                                   drop_rate=self._drop_rate_for(phase),
                                   momentum=self.server_momentum)
        self._phase_cache[ck] = fn
        return fn, False

    @property
    def cache_size(self) -> int:
        return len(self._cache) + len(self._phase_cache)

    def _record_stall(self, pi: int, kind: str, stall_s: float, warm: bool):
        self.stall_log.append({"phase": pi, "kind": kind,
                               "stall_s": round(stall_s, 6), "warm": warm})

    def _record(self, history, log_fn, *, gstep: int, pi: int, phase: Phase,
                loss, samples_seen: int, t0: float, wall_offset: float):
        """The per-step history record — the reference's schema."""
        rec = {"step": gstep, "phase": pi, "size": phase.input_size,
               "batch": phase.batch_size, "loss": round(float(loss), 4),
               "tokens": samples_seen,
               "wall_s": round(time.time() - t0 + wall_offset, 1),
               "compiled": self.cache_size}
        history.append(rec)
        if log_fn is not None:
            log_fn(rec)

    def _check_device(self, tree, what: str) -> None:
        for leaf in tree_leaves(tree):
            if isinstance(leaf, torch.Tensor) and leaf.device != self.device \
                    and not (leaf.dim() == 0 and leaf.device.type == "cpu"):
                raise ValueError(f"{what} live on {leaf.device} but the "
                                 f"engine runs on {self.device}")

    # ------------------------------------------------------------------
    def _chunk_feed(self, phase: Phase, batch_fn, start: int):
        """(c, batches) chunks for the flat-store path: the DataPlane's
        double-buffered feed when available, else inline stacking."""
        if hasattr(batch_fn, "scan_feed"):
            yield from batch_fn.scan_feed(phase, start, phase.n_steps,
                                          self.scan_chunk, self.device)
            return
        remaining, g0 = phase.n_steps, start
        while remaining:
            c = min(remaining, self.scan_chunk)
            staged = [_to_device(batch_fn(phase, g0 + j), self.device)
                      for j in range(c)]
            yield c, {k: torch.stack([b[k] for b in staged])
                      for k in staged[0]}
            remaining -= c
            g0 += c

    def _run_phase_scan(self, phase: Phase, pi: int, spec: FlatSpec, p2, v2,
                        batch_fn, seed: int, *, gstep: int,
                        samples_seen: int, start_step: int, log_every: int,
                        log_fn, history, t0: float, wall_offset: float,
                        phase_offset: int = 0):
        """One fused phase as chunks on the flat store; takes and returns
        the flat ``(p2, v2)`` carry.  Returns (p2, v2, gstep,
        samples_seen)."""
        drop = self._drop_rate_for(phase)
        t_enter = time.perf_counter()
        fn, cached = self.phase_fn(phase, spec)
        first = True
        for c, batches in self._chunk_feed(phase, batch_fn, gstep):
            if first:
                self._record_stall(pi + phase_offset, "scan",
                                   time.perf_counter() - t_enter, cached)
                first = False
            rngs = ([_drop_gen(self.device, seed, gstep + j)
                     for j in range(c)] if drop > 0 else None)
            p2, v2, losses = fn(p2, v2, batches, rngs)
            losses = losses.cpu().numpy()      # one device sync per chunk
            for j in range(c):
                gstep += 1
                samples_seen += phase.batch_size * phase.input_size
                if gstep == start_step + 1 or gstep % log_every == 0:
                    self._record(history, log_fn, gstep=gstep, pi=pi,
                                 phase=phase, loss=losses[j],
                                 samples_seen=samples_seen, t0=t0,
                                 wall_offset=wall_offset)
        return p2, v2, gstep, samples_seen

    def run(self, phases: Sequence[Phase], params, opt_state,
            batch_fn: Callable[[Phase, int], dict], *,
            seed: int = 0, log_every: int = 20,
            log_fn: Optional[Callable[[dict], None]] = None,
            start_step: int = 0, start_samples: int = 0,
            wall_offset: float = 0.0, phase_offset: int = 0):
        """Run the whole schedule.

        batch_fn(phase, global_step) -> batch dict ("images"/"labels",
        numpy or tensors); the engine attaches the phase layout's weights.
        A ``DataPlane`` works directly as ``batch_fn`` and additionally
        enables the double-buffered feed.  ``start_step`` offsets the
        global step counter (and so the dropout stream and ``batch_fn``
        indices); ``start_samples``/``wall_offset``/``phase_offset`` keep
        the logged counters cumulative under phase-at-a-time dispatch.
        The caller's params are never written: the flat store is a copy.
        Returns (params, opt_state, history).
        """
        self._check_device(params, "params")
        self._check_device(opt_state, "opt_state")
        history = []
        t0 = time.time()
        gstep = start_step
        samples_seen = start_samples
        mom = self.server_momentum
        flat = None  # (spec, vspec, p2, v2): params/opt_state stale if set
        if hasattr(batch_fn, "bind") and not getattr(batch_fn, "bound",
                                                     True):
            batch_fn.bind(phases)

        def materialize():
            """Leave the flat store: params/opt_state become current."""
            nonlocal params, opt_state, flat
            if flat is not None:
                spec, vspec, p2, v2 = flat
                # mixed precision carries (shadow, master); the f32 master
                # is the value of record
                params = spec.unravel(p2[1] if self._mixed else p2)
                if v2 is not None:
                    opt_state = dict(opt_state, v=vspec.unravel(v2))
                flat = None

        for pi, phase in enumerate(phases):
            kind = self._kind_for(phase)
            if self._use_scan(kind):
                if flat is None:
                    spec = self._param_spec(params)
                    p2 = ((spec.ravel(params), spec.ravel_master(params))
                          if self._mixed else spec.ravel(params))
                    vspec = v2 = None
                    if mom > 0:
                        if not (isinstance(opt_state, dict)
                                and "v" in opt_state):
                            raise ValueError(
                                "server_momentum needs an opt_state with a "
                                'params-shaped "v" tree (e.g. sgd_momentum)')
                        vspec = self._param_spec(opt_state["v"])
                        # the velocity stays f32 whatever the store dtype
                        v2 = vspec.ravel_master(opt_state["v"])
                else:
                    spec, vspec, p2, v2 = flat
                p2, v2, gstep, samples_seen = self._run_phase_scan(
                    phase, pi, spec, p2, v2, batch_fn, seed,
                    gstep=gstep, samples_seen=samples_seen,
                    start_step=start_step, log_every=log_every,
                    log_fn=log_fn, history=history, t0=t0,
                    wall_offset=wall_offset, phase_offset=phase_offset)
                flat = (spec, vspec, p2, v2)
                continue
            if mom > 0:
                raise ValueError(
                    f"server_momentum is set but phase {pi} ({kind}) "
                    "bypasses the fused scan path; PS-server momentum only "
                    "applies to fused dual-batch phases")
            if self._mixed:
                raise ValueError(
                    f"precision='bf16' is set but phase {pi} ({kind}) "
                    "bypasses the fused scan path; the bf16 store only "
                    "applies to fused dual-batch phases")
            materialize()
            t_enter = time.perf_counter()
            step, cached = self.step_fn(phase)
            drop = self._drop_rate_for(phase)
            for j in range(phase.n_steps):
                batch = _to_device(batch_fn(phase, gstep), self.device)
                if j == 0:
                    self._record_stall(pi + phase_offset, "step",
                                       time.perf_counter() - t_enter, cached)
                drop_rng = (_drop_gen(self.device, seed, gstep)
                            if drop > 0 else None)
                params, opt_state, metrics = step(params, opt_state, batch,
                                                  phase.lr, drop_rng)
                gstep += 1
                samples_seen += phase.batch_size * phase.input_size
                if gstep == start_step + 1 or gstep % log_every == 0:
                    self._record(history, log_fn, gstep=gstep, pi=pi,
                                 phase=phase, loss=metrics["loss"],
                                 samples_seen=samples_seen, t0=t0,
                                 wall_offset=wall_offset)
        materialize()
        return params, opt_state, history
