"""PS-sim ↔ SPMD parity checks, executable form (the port of the
reference's ``engine/parity.py``).

Five assertions on a tiny model:

1. **Factor-scaled merge parity** — the engine's weighted-SPMD step equals
   the parameter-server simulator's factor-scaled merge.  Each sim worker
   (momentum 0, one BSP iteration) pushes  f_i · (−lr_sim · ḡ_i)  onto the
   server; summing the per-worker deltas from IDENTICAL pulled params gives
   Δ_sim = −lr_sim · Σ_i f_i ḡ_i, which is the weighted step's update with
   lr_spmd = lr_sim · Σ_i f_i.
2. **Fused-kernel parity** — the fused ``dbl_merge`` step (B2) equals the
   unfused reference server update  w' = w − lr(g_L + f·g_S)/(1+f).
3. **Backend parity** — the SAME ``Phase`` list run through the two
   cluster backends agrees: ``PsSimBackend`` (BSP, single worker, factor
   1.0, momentum 0) and ``SpmdBackend`` (plain SGD) on an identical batch
   stream.
4. **DataPlane parity** — one ``DataPlane`` feeds both backends identical
   per-worker sample streams whatever the draw order, the plane-fed scan
   feed is bit-identical to inline staging, and a cyclic progressive
   schedule runs end to end through the plane on the simulator.
5. **Trace parity** — the traced simulator (schedule pass + flat-store
   replay, one B3 update per event) is bit-identical to the event path
   across BSP/ASP/SSP with jitter, mixed batch sizes, elastic membership
   and a per-epoch LR schedule, in both update forms (the B3 wrapper and
   its plain version).

Checks 3 and 5 also carry a ``precision="bf16"`` mode (bf16 shadow + f32
master) gated by the reference's tolerance bands; timeline facts stay
exact.

The reference runs these on a reduced ``phi3-mini-3.8b``, which the port
trains too since its LM slice (moving these checks onto it is left,
ROADMAP A12a); here the tiny model is a width-8
``cifar-resnet18`` (10 classes) on 8 px images (16 px in the data-plane
check's second phase).  At 8 px the last stage is 1 x 1; at 16 px it is
2 x 2, where the instance norm of near-constant channels amplifies
rounding differences far beyond these bands (ROADMAP C4).  Every check runs on
``device`` (``None`` means the card); the bit-for-bit checks (4b, and 5
in f32) run on cuDNN's deterministic kernels, as its default ones do not
repeat themselves on the card.

Run directly:  PYTHONPATH=src python -m repro_torch.engine.parity [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import json
from dataclasses import replace

import torch

from repro_torch import models
from repro_torch.cluster import (ASP, BSP, SSP, ClusterEvent, PsSimBackend,
                                 SpmdBackend, WorkerSpec, simulate,
                                 simulate_traced, workers_from_plan)
from repro_torch.configs import get_config
from repro_torch.core import LinearTimeModel, solve_plan
from repro_torch.core.spmd_dual_batch import SpmdDualBatch
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten
from repro_torch.data import DataPlane, SyntheticImages
from repro_torch.device import resolve_device, strict_f32
from repro_torch.engine.engine import TrainEngine
from repro_torch.engine.phases import single_phase
from repro_torch.engine.steps import make_fused_dbl_step, make_weighted_step
from repro_torch.optim import sgd_momentum


def _device(device) -> torch.device:
    """The checks' device (``None`` means the card), with TF32 off: the
    step functions are called here without an engine or backend, which
    would otherwise turn it off."""
    device = resolve_device(device)
    strict_f32(device)
    return device


def _tiny_setup(seed: int, device):
    cfg = replace(get_config("cifar-resnet18"), d_model=8, vocab_size=10)
    gen = torch.Generator().manual_seed(seed)
    params = models.init_params(cfg, gen, device=device)
    return cfg, params, _images(gen, 8, 8, device)


def _images(gen: torch.Generator, n: int, res: int, device) -> dict:
    return {"images": torch.rand((n, res, res, 3), generator=gen).to(device),
            "labels": torch.randint(0, 10, (n,), generator=gen,
                                    dtype=torch.int32).to(device)}


def _grad_fn(cfg):
    def grad_fn(p, b):
        leaves, treedef = tree_flatten(p)
        xs = [leaf.detach().requires_grad_() for leaf in leaves]
        loss, _ = models.loss_fn(tree_unflatten(treedef, xs), cfg, b)
        return tree_unflatten(treedef, list(torch.autograd.grad(loss, xs)))
    return grad_fn


def _max_diff(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _copy(tree):
    return tree_map(torch.clone, tree)


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic kernels for the bit-for-bit checks: its
    default kernels do not repeat themselves on the card."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def check_merge_parity(*, seed: int = 0, lr_sim: float = 0.05,
                       atol: float = 2e-5, device=None) -> dict:
    """Weighted-SPMD step vs the simulator's factor-scaled merge."""
    device = _device(device)
    cfg, params, batch = _tiny_setup(seed, device)
    tm = LinearTimeModel(a=1.0, b=24.6)
    plan = solve_plan(tm, B_L=64, d=4096, n_workers=4, n_small=2, k=1.05)
    f = plan.update_factor_small
    pw = 2                                 # 8 examples over 4 worker-rows
    layout = SpmdDualBatch(global_batch=8, n_workers=4, n_small=2,
                           small_valid=pw, factor_small=f)
    factors = [1.0] * (layout.n_workers - layout.n_small) \
        + [f] * layout.n_small
    lr_spmd = lr_sim * sum(factors)

    opt = sgd_momentum(0.0)
    step = make_weighted_step(cfg, opt, layout=layout)
    p_spmd, _, metrics = step(params, opt.init(params), batch, lr_spmd, None)

    grad_fn = _grad_fn(cfg)
    merged = params
    for i, fac in enumerate(factors):
        wbatch = {k: v[i * pw:(i + 1) * pw] for k, v in batch.items()}
        res = simulate(
            params, grad_fn, lambda rng, wid, bsz, wb=wbatch: wb,
            [WorkerSpec(batch_size=pw, data_per_epoch=pw,
                        update_factor=fac, iter_time=1.0)],
            epochs=1, lr_for_epoch=lambda e: lr_sim, sync="bsp",
            momentum=0.0, seed=seed)
        merged = tree_map(lambda m, a, b: m + (a - b), merged, res.params,
                          params)
    diff = _max_diff(p_spmd, merged)
    assert diff < atol, (
        f"PS-sim merge and weighted-SPMD step diverge: {diff} >= {atol}")
    return {"max_param_diff": diff, "factor_small": f,
            "loss": float(metrics["loss"])}


def check_fused_parity(*, seed: int = 0, lr: float = 0.05,
                       atol: float = 1e-5, device=None) -> dict:
    """Fused dbl_merge step (B2) vs the unfused reference update."""
    device = _device(device)
    cfg, params, batch = _tiny_setup(seed, device)
    layout = SpmdDualBatch(global_batch=8, n_workers=4, n_small=2,
                           small_valid=1, factor_small=0.7)
    s0 = sgd_momentum(0.0).init(params)
    p_f, _, m_f = make_fused_dbl_step(cfg, layout, fused=True)(
        params, s0, batch, lr, None)
    p_u, _, _ = make_fused_dbl_step(cfg, layout, fused=False)(
        params, s0, batch, lr, None)
    diff = _max_diff(p_f, p_u)
    assert diff < atol, (
        f"fused dbl_merge and unfused update diverge: {diff} >= {atol}")
    assert bool(torch.isfinite(m_f["loss"]))
    return {"max_param_diff": diff, "loss": float(m_f["loss"])}


def check_backend_parity(*, seed: int = 0, lr: float = 0.05,
                         atol: float = None, rtol: float = 0.0,
                         precision: str = "f32", device=None) -> dict:
    """One schedule, two backends: PsSimBackend vs SpmdBackend on an
    identical batch stream -> matching final params.

    ``precision="f32"``: BSP, 1 worker, factor 1.0, momentum 0 on the sim
    side vs plain SGD on the SPMD side, within ``atol`` 2e-5.
    ``precision="bf16"``: the traced sim's bf16 store vs the engine's
    fused bf16 scan, in a geometry where both updates are the same merge
    (equal large/small halves, ``factor_small=1.0``, all small rows
    valid); the residual is gradient reduction order and bf16 rounding,
    gated at ``atol`` 2e-3 (the reference's band)."""
    device = _device(device)
    mixed = precision == "bf16"
    if atol is None:
        atol = 2e-3 if mixed else 2e-5
    cfg, params, _ = _tiny_setup(seed, device)
    tm = LinearTimeModel(a=1.0, b=24.6)
    # one large worker, factor 1.0, exactly 1 iteration per epoch (d == B_L)
    plan = solve_plan(tm, B_L=8, d=8, n_workers=1, n_small=0, k=1.0)
    gen = torch.Generator().manual_seed(seed + 2)
    batches = [_images(gen, 8, 8, device) for _ in range(4)]
    phases = single_phase(input_size=8, n_steps=2, lr=lr, batch_size=8,
                          plan=plan, epochs=2) \
        + single_phase(input_size=8, n_steps=2, lr=lr / 5, batch_size=8,
                       plan=plan, epochs=2)
    if mixed:
        layout = SpmdDualBatch(global_batch=8, n_workers=4, n_small=2,
                               small_valid=2, factor_small=1.0)
        phases = tuple(replace(p, layout=layout) for p in phases)

    counter = {"i": 0}

    def fns_factory(input_size):
        def data_fn(rng, wid, bsz):
            b = batches[counter["i"]]
            counter["i"] += 1
            return b
        return _grad_fn(cfg), data_fn, None

    res_sim = PsSimBackend(fns_factory, tm=tm, sync=BSP(), momentum=0.0,
                           traced=mixed, precision=precision,
                           device=device).run(phases, _copy(params),
                                              seed=seed)
    engine = TrainEngine(cfg, sgd_momentum(0.0), sgd_server=mixed,
                         precision=precision, device=device)
    res_spmd = SpmdBackend(engine, lambda phase, gstep: batches[gstep]).run(
        phases, _copy(params), seed=seed)

    diff = _max_diff(res_sim.params, res_spmd.params)
    ok = all(torch.allclose(a.float(), b.float(), atol=atol, rtol=rtol)
             for a, b in zip(tree_leaves(res_sim.params),
                             tree_leaves(res_spmd.params)))
    assert ok, (
        f"PsSimBackend and SpmdBackend diverge on the same schedule "
        f"(precision={precision}): max abs diff {diff} outside "
        f"atol={atol} rtol={rtol}")
    assert [r["steps"] for r in res_sim.phases] \
        == [r["steps"] for r in res_spmd.phases] == [2, 2]
    assert [r["phase"] for r in res_sim.phases] == [0, 1]
    return {"max_param_diff": diff, "sim_time": res_sim.time,
            "precision": precision,
            "spmd_steps": sum(r["steps"] for r in res_spmd.phases)}


def check_data_plane_parity(*, seed: int = 0, device=None) -> dict:
    """One DataPlane, two backends: (a) identical per-worker sample streams
    regardless of draw order, the simulator side drawing its REAL
    ``WorkerSpec`` batch sizes in the canonical geometry where worker rows
    are B_L wide; (b) the plane-fed scan feed is bit-identical to inline
    staging; (c) a cyclic schedule runs end to end through the plane on
    the PS-sim backend."""
    device = _device(device)
    cfg, params, _ = _tiny_setup(seed, device)
    tm = LinearTimeModel(a=1.0, b=24.6)
    plan = solve_plan(tm, B_L=2, d=64, n_workers=4, n_small=2, k=1.05)
    phases = single_phase(input_size=8, n_steps=2, lr=0.01, batch_size=8,
                          plan=plan, epochs=1) \
        + single_phase(input_size=16, n_steps=2, lr=0.01, batch_size=8,
                       plan=plan, epochs=1)
    data = SyntheticImages(n_train=256, n_test=16, num_classes=10, seed=seed)

    # (a) per-worker stream identity, the sim drawing in reversed worker
    # order at the WorkerSpec batch sizes
    plane = DataPlane(data, seed=seed).bind(phases)
    specs = workers_from_plan(plan, tm)
    checked = 0
    for pi, phase in enumerate(phases):
        rows = plane.worker_rows(phase)
        assert [v for _, v, _ in rows] == [s.batch_size for s in specs], \
            "geometry not aligned: sim batch sizes != spmd valid rows"
        df = plane.sim_data_fn(pi, phase, device)
        sim_draws = {}
        for t in range(phase.n_steps):
            for (w, _, _), spec in reversed(list(zip(rows, specs))):
                sim_draws[(w, t)] = df(None, w, spec.batch_size)["images"]
        for t in range(phase.n_steps):
            gb = plane(phase, plane._starts[pi] + t)
            ofs = 0
            for w, valid, rcount in rows:
                canon = torch.from_numpy(data.batch_at(
                    plane.worker_indices(pi, w, t, valid),
                    phase.input_size)["images"])
                assert torch.equal(sim_draws[(w, t)].cpu(), canon), \
                    f"sim stream diverges at phase {pi} worker {w} step {t}"
                assert torch.equal(torch.from_numpy(
                    gb["images"][ofs:ofs + valid]), canon), \
                    f"spmd rows diverge at phase {pi} worker {w} step {t}"
                ofs += rcount
                checked += 1

    # (b) plane feed (side-stream staging) vs inline staging, bit for bit
    def run_spmd(batch_fn):
        engine = TrainEngine(cfg, sgd_momentum(0.0), sgd_server=True,
                             scan_chunk=2, device=device)
        return SpmdBackend(engine, batch_fn).run(phases, _copy(params),
                                                 seed=seed)

    with DataPlane(data, seed=seed) as fed, _deterministic():
        res_new = run_spmd(fed)
        legacy_plane = DataPlane(data, seed=seed).bind(phases)
        res_old = run_spmd(lambda ph, g: legacy_plane(ph, g))
    assert [h["loss"] for h in res_new.history] \
        == [h["loss"] for h in res_old.history], \
        "plane-fed scan feed changed the training history"
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(res_new.params), tree_leaves(res_old.params))
               ), "plane-fed scan feed changed the final params"

    # (c) the same plane drives the event-driven simulator end to end
    def fns_factory(input_size):
        return _grad_fn(cfg), None, None        # data comes from the plane

    with DataPlane(data, seed=seed) as sim_plane:
        res_sim = PsSimBackend(fns_factory, tm=tm, sync=BSP(), momentum=0.0,
                               plane=sim_plane, device=device).run(
            phases, _copy(params), seed=seed)
    assert len(res_sim.phases) == len(phases)
    assert all(bool(torch.isfinite(leaf).all())
               for leaf in tree_leaves(res_sim.params))
    return {"streams_checked": checked,
            "history_len": len(res_new.history),
            "sim_pushes": sum(r["steps"] for r in res_sim.phases)}


def check_trace_parity(*, seed: int = 0, precision: str = "f32",
                       atol: float = 5e-3, rtol: float = 0.0,
                       device=None) -> dict:
    """5. **Trace parity** — the traced simulator replays the event path
    BIT-IDENTICALLY (f32): same final params, same per-epoch history (eval
    metrics included), same ``n_pushes`` and ``sim_time`` — under all
    three sync policies, with jitter 0.2, mixed worker batch sizes, a
    per-epoch LR schedule and an elastic join + leave, in both update
    forms (``"pallas"``: the B3 wrapper; ``"xla"``: its plain version).

    ``precision="bf16"`` holds the bf16 replay against the SAME f32 event
    path: timeline facts exactly, params within ``atol`` (5e-3) and eval
    losses within ``atol + 1e-2`` (the reference's bands)."""
    device = _device(device)
    cfg, params, _ = _tiny_setup(seed, device)
    bank = _images(torch.Generator().manual_seed(seed + 3), 128, 8, device)
    grad_fn = _grad_fn(cfg)

    def data_fn(rng, wid, bsz):
        idx = torch.from_numpy(rng.integers(0, 128, size=bsz)).to(device)
        return {k: v[idx] for k, v in bank.items()}

    def eval_fn(p):
        with torch.no_grad():
            loss, _ = models.loss_fn(p, cfg, {k: v[:8]
                                              for k, v in bank.items()})
        return {"loss": float(loss)}

    workers = [WorkerSpec(8, 16, 1.0, 0.1, 0.2),     # B_L rows
               WorkerSpec(4, 16, 0.8, 0.07, 0.2)]    # B_S rows (switch)
    elastic = (ClusterEvent(time=0.25, action="join",
                            worker=WorkerSpec(8, 16, 0.5, 0.1, 0.2)),
               ClusterEvent(time=0.8, action="leave", worker_id=1))
    checked = 0
    for sync, events in ((BSP(), ()), (ASP(), elastic), (SSP(1), ())):
        kw = dict(epochs=2,
                  lr_for_epoch=lambda e: 0.05 if e < 1 else 0.01,
                  sync=sync, momentum=0.9, seed=seed + 7, events=events,
                  eval_fn=eval_fn)
        with _deterministic():
            ref = simulate(params, grad_fn, data_fn, workers, **kw)
        for update in ("xla", "pallas"):
            with _deterministic():
                res = simulate_traced(params, grad_fn, data_fn, workers,
                                      scan_chunk=8, update=update,
                                      precision=precision, **kw)
            for a, b in zip(tree_leaves(ref.params), tree_leaves(res.params)):
                if precision == "f32":
                    assert torch.equal(a, b), (
                        f"trace params diverge from the event path "
                        f"(sync={sync.name}, update={update})")
                else:
                    assert torch.allclose(a, b.float(), atol=atol,
                                          rtol=rtol), (
                        f"bf16 trace params leave the tolerance band vs "
                        f"the f32 event path (sync={sync.name}, "
                        f"update={update}, atol={atol}, rtol={rtol})")
            if precision == "f32":
                assert res.history == ref.history, (
                    f"trace history diverges (sync={sync.name}, "
                    f"update={update})")
            else:
                assert [(h["epoch"], h["sim_time"]) for h in res.history] \
                    == [(h["epoch"], h["sim_time"]) for h in ref.history]
                assert all(abs(a["loss"] - b["loss"]) <= atol + 1e-2
                           for a, b in zip(res.history, ref.history)), (
                    f"bf16 trace eval losses leave the band "
                    f"(sync={sync.name}, update={update})")
            assert res.n_pushes == ref.n_pushes
            assert res.sim_time == ref.sim_time
            checked += 1
    return {"configs_checked": checked, "precision": precision,
            "events_replayed": ref.n_pushes}


def check_parity(*, seed: int = 0, device=None) -> dict:
    """Run all checks on ``device`` (``None`` means the card); raises
    AssertionError on any mismatch."""
    kw = dict(seed=seed, device=device)
    return {"merge": check_merge_parity(**kw),
            "fused": check_fused_parity(**kw),
            "backend": check_backend_parity(**kw),
            "data_plane": check_data_plane_parity(**kw),
            "trace": check_trace_parity(**kw),
            "backend_bf16": check_backend_parity(precision="bf16", **kw),
            "trace_bf16": check_trace_parity(precision="bf16", **kw)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="PS-sim / SPMD parity checks")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the card)")
    dev = resolve_device(ap.parse_args().device)
    if dev.type == "cpu":
        # multi-threaded oneDNN conv backward has aborted the process on
        # small ResNets (ROADMAP C5)
        torch.set_num_threads(1)
    print(json.dumps(check_parity(device=dev), indent=1))
    print("parity OK")
