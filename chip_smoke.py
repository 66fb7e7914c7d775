#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each of which raises (and so exits non-zero) on any failure:

1. device: the card's name and power limit, and the build of the port's
   CUDA kernels from ``src/repro_torch/csrc`` (nvcc, at first use);
2. kernels: every variant of ``dbl_apply_flat2d`` (B1),
   ``dbl_merge_flat2d`` (B2) and ``dbl_apply_worker_flat2d`` (B3, over a
   stacked velocity of 3 workers at 64 rows and 4 otherwise, checking that
   only worker 1's rows change), on N(0, 1) inputs from a seeded generator
   on the card, held bit for bit against its plain PyTorch version at a
   whole-buffer shape (64 rows), a gridded one (3072 rows) and the full
   ResNet-18 flat-store shape, and timed at the full store with CUDA
   events (median of 7 groups of 20 back-to-back launches, after warm-up)
   beside the plain version, the one-call PyTorch equivalent where there
   is one, and the least time the card could take (bytes moved over the
   memory rate);
3. main path: ``repro_torch.api.run`` on the hybrid dual-batch x CPL
   schedule at the full width of ``cifar-resnet18`` (stem 64, 100
   classes, 24 -> 32 px, global batch 512 at 32 px, 40 steps): one B1
   launch per step, parameters on the card, finite and falling loss;
4. other paths: 4 full-width steps each with server momentum, the bf16
   store (with and without momentum) and the per-step loop (B2), each
   with its own launch count;
5. parity: the same schedule at width 8 on the card and on the CPU (the
   CPU port is what the repository's tests hold against the JAX package),
   within ``PARITY_BAND``; a second card run with TF32 turned back on
   shows how far a planted precision fault lands from the CPU;
6. profile: where a step's time goes per CPL rung (``profile_rungs``);
7. PS-sim main path: ``repro_torch.api.run(backend="ps_sim",
   traced=True)`` on the hybrid spec of the accuracy example at the full
   width of ``cifar-resnet18`` (4 phases, 124 events): one B3 launch per
   event and nothing else, 4 finite evaluations, params on the card; per
   phase ms per event, images/s, time to the first event and the host
   seconds to stage a chunk, and a profile of one event per resolution;
8. PS-sim event path on the same spec: no kernel launch, and the same
   timeline as the traced run (``n_pushes``, ``sim_time``, evaluation
   epochs and times); its param gap to the traced run within
   ``EVENT_BAND``; then both paths again on cuDNN's deterministic
   kernels, where the traced replay must repeat itself and the event path
   match it bit for bit;
9. the bf16 store through the traced replay (B3's master form, one launch
   per event);
10. PS-sim parity: the traced replay at width 8 on the card (started with
    TF32 on, which the backend turns off) against the CPU port, within
    ``PS_PARITY_BAND``.

The launch counts are set to 0 just before each path and read just after;
the ``launches`` in the kernels line are those counts, summed over the
main path and the short runs.  Launches made to compare a kernel with its
plain version are not counted.
The last three lines of standard output are the card's name and power
limit (as ``nvidia-smi`` gives them), one JSON object with the kernels'
numbers, and ``{"ok": true, "device": {...}}``.
"""
import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "src/repro_torch/csrc/dbl_merge.cu"
REFERENCE = "src/repro/kernels/dbl_merge.py"

# the card's device-memory rate and f32 rate outside the tensor cores
# (NVIDIA's H100 SXM data sheet), for the bounds
MEM_RATE = {"NVIDIA H100 80GB HBM3": 3.35e12}
F32_RATE = 67e12
# extra shapes every variant is held bit-equal at (a whole-buffer and a
# gridded one in the reference's geometry), beside the full store
CHECK_ROWS = (64, 3072)
PROFILE_STEPS = 5

# the PS simulator's main path: the hybrid spec of the accuracy example
# (examples/train_resnet18_e2e.py) at 4 epochs — 24 -> 32 -> 24 -> 32 px,
# 23 + 39 + 23 + 39 events, batches 113 / 91 at 24 px and 64 / 51 at 32 px
PS_SPEC = dict(scheme="hybrid", input_size=32, batch_size=64,
               dataset_size=2048, n_workers=4, n_small=3, k=1.05, epochs=4,
               lr=0.05, sub_sizes=(24, 32), sub_dropouts=(0.0, 0.0),
               stage_epochs=(2, 2), stage_lrs=(0.05, 0.01), tm_a=0.001,
               tm_b=0.0246, sync="asp", seed=0)
PS_EVENTS = 124
# the bf16 store on a dual-batch spec of 32 events
BF16_SPEC = dict(scheme="dbl", input_size=32, batch_size=64,
                 dataset_size=768, n_workers=4, n_small=3, k=1.05, epochs=2,
                 lr=0.05, tm_a=0.001, tm_b=0.0246, sync="asp", seed=0)
# card vs CPU on a width-8 two-phase run (4 -> 8 px, 16 events; at these
# sizes the CPU port's f32 run lies 3.5e-9 from its f64 run, so the two
# devices' rounding differences are not amplified).  The eval losses are
# the accuracy example's, rounded to 3 decimals.
PS_SMALL_SPEC = dict(scheme="hybrid", input_size=8, batch_size=8,
                     dataset_size=64, n_workers=4, n_small=3, k=1.05,
                     epochs=2, lr=0.05, sub_sizes=(4, 8),
                     sub_dropouts=(0.0, 0.0), stage_epochs=(2,),
                     stage_lrs=(0.05,), sync="asp", seed=0)
PS_PARITY_BAND = {"loss": 1.5e-3, "params": 1e-5}
# event path vs traced replay at full width on cuDNN's default kernels,
# final params, max abs: those kernels do not repeat themselves bit for bit,
# and ResNet training amplifies any rounding difference over 124 events at
# lr 0.05 (ROADMAP C4).  Measured on NVIDIA H100 80GB HBM3, 700 W: event vs
# traced 0.0629 / 0.0633, traced vs traced 0.0621 / 0.0617 (two runs).  The
# band is four times that; on deterministic kernels the paths agree bit for
# bit (asserted).
EVENT_BAND = 0.25

# per variant: (reference inner kernel line, bytes per element, f32 ops
# per element) — each input read once, each output written once
B1 = {"plain": (87, 12, 2), "vel": (93, 20, 4), "master": (132, 14, 2),
      "master_vel": (141, 22, 4)}
B2 = {"plain": (68, 16, 5), "vel": (76, 24, 7), "master": (106, 18, 5),
      "master_vel": (118, 26, 7)}
B3 = {"plain": (270, 20, 5), "master": (287, 22, 5)}
KERNEL_INFO = {"dbl_apply_flat2d": (229, B1), "dbl_merge_flat2d": (186, B2),
               "dbl_apply_worker_flat2d": (318, B3)}
WORKER = "dbl_apply_worker_flat2d"
# B3's stacked velocity: 3 workers at 64 rows, else the main path's 4; the
# event updates worker 1
B3_WORKERS = {64: 3}
N_WORKERS, WID = 4, 1

LR, FACTOR, MOM = 0.05, 0.9365079365079365, 0.9

# card vs CPU port on the width-8 schedule at lr 0.005: measured 0.0 on
# the loss and 1.19e-7 on the params (NVIDIA H100 80GB HBM3, 700 W).  The
# losses are the history's, rounded to 4 decimals, so one rounding unit
# (1e-4) can separate two equal runs.
PARITY_BAND = {"loss": 1.5e-4, "params": 1e-5}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def mem_rate(name: str) -> float:
    if name not in MEM_RATE:
        raise RuntimeError(f"no memory rate on file for {name!r}: add its "
                           "data-sheet rate to MEM_RATE")
    return MEM_RATE[name]


def cuda_ms(fn, per_group: int = 20, groups: int = 7,
            warmup: int = 5) -> float:
    """Milliseconds per call of ``fn`` on the card: CUDA events around
    ``per_group`` back-to-back calls (so the host's launch overhead
    overlaps the previous call's device time), median over ``groups``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_group):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_group)
    return statistics.median(times)


# ------------------------------ phase 2: kernels -----------------------------
def _buffers(rows, variant, kernel, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *lead: torch.randn(*lead, rows, 128, generator=gen,
                                    device="cuda")
    bufs = {"w": rnd(), "g": rnd()}
    if kernel == "dbl_merge_flat2d":
        bufs["gs"] = rnd()
    if "vel" in variant:
        bufs["v"] = rnd()
    if kernel == WORKER:
        bufs["v"] = rnd(B3_WORKERS.get(rows, N_WORKERS))
    if "master" in variant:
        bufs["shadow"] = bufs["w"].to(torch.bfloat16)
    return bufs


def _call(K, kernel, variant, b, plain: bool):
    """One update of ``b`` in place, by the kernel or its plain version."""
    if kernel == WORKER:
        fn = K.dbl_apply_worker_plain if plain else K.dbl_apply_worker_flat2d
        if variant == "master":
            return fn(b["shadow"], b["g"], b["v"], WID, LR, FACTOR, MOM,
                      master2=b["w"])
        return fn(b["w"], b["g"], b["v"], WID, LR, FACTOR, MOM)
    kw = {"lr": LR}
    if "vel" in variant:
        kw.update(vel2=b["v"], momentum=MOM)
    if "master" in variant:
        kw["master2"] = b["w"]
        p2 = b["shadow"]
    else:
        p2 = b["w"]
    if kernel == "dbl_merge_flat2d":
        fn = K.dbl_merge_plain if plain else K.dbl_merge_flat2d
        return fn(p2, b["g"], b["gs"], factor=FACTOR, **kw)
    fn = K.dbl_apply_plain if plain else K.dbl_apply_flat2d
    return fn(p2, b["g"], **kw)


def _library_call(kernel, variant, b):
    """One PyTorch call computing the same function, where there is one."""
    if kernel == WORKER and variant == "plain":
        # SGD with momentum at lr f*lr: the same update, rounded otherwise
        return lambda: torch._fused_sgd_(
            [b["w"]], [b["g"]], [b["v"][WID]], weight_decay=0.0,
            momentum=MOM, lr=FACTOR * LR, dampening=0.0, nesterov=False,
            maximize=False, is_first_step=False)
    if kernel != "dbl_apply_flat2d":
        return None
    if variant == "plain":
        return lambda: b["w"].add_(b["g"], alpha=-LR)
    if variant == "vel":
        return lambda: torch._fused_sgd_(
            [b["w"]], [b["g"]], [b["v"]], weight_decay=0.0, momentum=MOM,
            lr=LR, dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False)
    return None


def _check(K, kernel, variant, rows, seed):
    """One launch of the kernel and one of its plain version on the same
    inputs; raises unless every output is bit-equal and the bf16 shadow is
    the rounded master.  Returns both buffer sets, updated."""
    ref = _buffers(rows, variant, kernel, seed)
    plain = {k: t.clone() for k, t in ref.items()}
    before = ref["v"].clone() if kernel == WORKER else None
    _call(K, kernel, variant, ref, plain=False)
    _call(K, kernel, variant, plain, plain=True)
    torch.cuda.synchronize()
    if before is not None:
        others = [i for i in range(before.shape[0]) if i != WID]
        if not torch.equal(ref["v"][others], before[others]) or \
                torch.equal(ref["v"][WID], before[WID]):
            raise AssertionError(f"{kernel}[{variant}] at {rows} rows: the "
                                 "kernel wrote another worker's velocity "
                                 "rows, or not its own")
    for name in ref:
        if not torch.equal(ref[name], plain[name]):
            raise AssertionError(
                f"{kernel}[{variant}] {name} at {rows} rows: kernel differs "
                "from its plain version by "
                f"{float((ref[name].float() - plain[name].float()).abs().max())}")
    if "master" in variant and not torch.equal(
            ref["shadow"], ref["w"].to(torch.bfloat16)):
        raise AssertionError(f"{kernel}[{variant}] at {rows} rows: bf16 "
                             "shadow is not the rounded master")
    return ref, plain


def kernel_phase(K, rows: int, rate: float):
    out = []
    n = rows * 128
    for kernel, (fn_line, table) in KERNEL_INFO.items():
        for vi, (variant, (line, nbytes, nops)) in enumerate(table.items()):
            for r in CHECK_ROWS:
                _check(K, kernel, variant, r, seed=r + vi)
            ref, plain = _check(K, kernel, variant, rows, seed=vi)
            err = max(float((ref[k].float() - plain[k].float()).abs().max())
                      for k in ref)
            ms = cuda_ms(lambda: _call(K, kernel, variant, ref, plain=False))
            plain_ms = cuda_ms(lambda: _call(K, kernel, variant, plain,
                                             plain=True))
            lib = _library_call(kernel, variant, plain)
            library_ms = cuda_ms(lib) if lib is not None else None
            bound_ms = max(n * nbytes / rate, n * nops / F32_RATE) * 1e3
            rec = {"variant": variant, "replaces": f"{REFERENCE}:{line}",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": "bytes"
                   if n * nbytes / rate >= n * nops / F32_RATE
                   else "operations", "library_ms": library_ms,
                   "bytes": n * nbytes}
            out.append((kernel, fn_line, rec))
            log(f"  {kernel}[{variant}]: bit-equal to plain at "
                f"{CHECK_ROWS + (rows,)} rows; kernel "
                f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
                f"library {'-' if library_ms is None else f'{library_ms * 1e3:.1f} us'}"
                f", bound {bound_ms * 1e3:.1f} us "
                f"({bound_ms / ms:.0%} of the memory roofline)")
            del ref, plain
    torch.cuda.empty_cache()
    return out


# ------------------------------ phases 3-5: paths ----------------------------
def _spec(api, **kw):
    base = dict(scheme="hybrid", input_size=32, axis="resolution",
                sub_sizes=(24, 32), batch_size=512, dataset_size=8192,
                n_workers=4, n_small=3, k=1.05, n_steps=40,
                stage_lrs=(0.05,), seed=0)
    base.update(kw)
    return api.ScheduleSpec(**base)


def _launches(K):
    return {k: {v: K.launch_count(k, v) for v in vs}
            for k, vs in K.KERNEL_VARIANTS.items()}


def drive(m, spec, cfg, *, device, source, engine_kw=None, params=None,
          precision="f32", tf32=False):
    """One run of ``repro_torch.api.run`` with the launch counts set to 0
    just before it; returns what the run shows.  ``tf32=True`` turns TF32
    back on after the engine turned it off (a planted fault for the parity
    band)."""
    engine = m.TrainEngine(cfg, m.sgd_momentum(0.0), sgd_server=True,
                           device=device, precision=precision,
                           **(engine_kw or {}))
    if params is None:
        params = m.models.init_params(cfg, torch.Generator().manual_seed(0),
                                      device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    m.K.reset_counts()
    t0 = time.perf_counter()
    try:
        res = m.api.run(spec, m.api.RunConfig(backend="spmd", log_every=1,
                                              precision=precision),
                        init_params=params, engine=engine, data=source)
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    wall = time.perf_counter() - t0
    launches = _launches(m.K)
    losses = [h["loss"] for h in res.history]
    if len(losses) != spec.n_steps:
        raise AssertionError(f"{len(losses)} logged losses for "
                             f"{spec.n_steps} steps")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    for leaf in m.tree_leaves(res.params):
        if leaf.device.type != device or not bool(torch.isfinite(leaf).all()):
            raise AssertionError("params left the device or are not finite")
    return {"res": res, "launches": launches, "total": m.K.launch_count(),
            "plain_runs": m.K.plain_count(), "wall_s": wall,
            "losses": losses, "stalls": engine.stall_log}


def profile_rungs(m, cfg, spec, source, steps: int):
    """Where a step's time goes, per CPL rung of ``spec``: ``steps`` steps
    on batches already on the card (timed and traced after one warm-up
    pass), the host's time to build one batch, and the device kernels by
    total time."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile
    out = []
    engine = m.TrainEngine(cfg, m.sgd_momentum(0.0), sgd_server=True,
                           device="cuda", scan_chunk=steps)
    params = m.models.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cuda")
    plane = m.DataPlane(source, seed=spec.seed)
    phases = spec.to_phases()
    plane.bind(phases)
    for ph in phases:
        t0 = time.perf_counter()
        host = [plane(ph, j) for j in range(steps)]
        host_ms = 1e3 * (time.perf_counter() - t0) / steps
        staged = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
                  for b in host]
        short = dataclasses.replace(ph, n_steps=steps)
        feed = lambda _ph, g: staged[g]
        engine.run([short], params, None, feed)            # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.run([short], params, None, feed)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                kern[ev.name] = kern.get(ev.name, 0.0) + \
                    ev.time_range.elapsed_us()
        busy_us = sum(kern.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:10]
        rec = {"input_size": ph.input_size, "batch": ph.batch_size,
               "ms_per_step": 1e3 * wall / steps,
               "device_busy_ms_per_step": busy_us / 1e3 / steps,
               "device_idle_share": 1.0 - busy_us / 1e6 / wall,
               "host_batch_ms": host_ms,
               "top_kernels": [{"name": n[:90], "ms_per_step": t / 1e3 / steps,
                                "share": t / busy_us} for n, t in top]}
        out.append(rec)
        log(f"profile {ph.input_size} px (batch {ph.batch_size}, {steps} "
            f"steps on staged batches): {rec['ms_per_step']:.1f} ms/step, "
            f"device busy {rec['device_busy_ms_per_step']:.1f} ms/step "
            f"(idle {rec['device_idle_share']:.0%}); host builds one batch "
            f"in {host_ms:.0f} ms")
        for k in rec["top_kernels"]:
            log(f"    {k['ms_per_step']:7.2f} ms/step {k['share']:6.1%}  "
                f"{k['name']}")
    return out


# ------------------------------ phases 7-10: the PS simulator ----------------
def drive_ps(m, spec, cfg, fns, source, *, traced, device="cuda",
             precision="f32", params=None, tf32=False):
    """One run of ``repro_torch.api.run(backend="ps_sim")`` with the launch
    counts set to 0 just before it; returns what the run shows.
    ``tf32=True`` leaves TF32 on (PyTorch's default for convolutions) when
    the run starts: the backend must turn it off itself."""
    if params is None:
        params = m.models.init_params(cfg, torch.Generator().manual_seed(0),
                                      device=device)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    records = []
    m.K.reset_counts()
    t0 = time.perf_counter()
    res = m.api.run(spec, m.api.RunConfig(traced=traced, momentum=MOM,
                                          precision=precision,
                                          log_fn=records.append),
                    init_params=params, fns_factory=fns, data=source,
                    device=device)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the PS-sim path left TF32 on")
    n_evals = sum(max(1, p.epochs) for p in spec.to_phases())
    losses = [h["test_loss"] for h in res.history]
    if len(losses) != n_evals or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"history {res.history}: expected {n_evals} "
                             "finite evaluations")
    for leaf in m.tree_leaves(res.params):
        if leaf.device.type != device or not bool(torch.isfinite(leaf).all()):
            raise AssertionError("params left the device or are not finite")
    return {"res": res, "launches": _launches(m.K),
            "total": m.K.launch_count(), "plain_runs": m.K.plain_count(),
            "wall_s": wall, "records": records, "losses": losses,
            "peak": torch.cuda.max_memory_allocated() if cuda else 0}


def phase_traces(m, spec):
    """Each phase's ``SimTrace`` as the backend builds it (the schedule
    pass is host-only and deterministic), to count images per phase and
    stage chunks outside the run."""
    out = []
    for i, ph in enumerate(spec.to_phases()):
        tm = m.scaled_time_model(spec.time_model(), ph.input_size,
                                 spec.input_size, axis=spec.axis)
        out.append(m.schedule_pass(
            m.workers_from_plan(ph.plan, tm), epochs=max(1, ph.epochs),
            lr_for_epoch=ph.lr_for_epoch or (lambda e, lr=ph.lr: lr),
            sync=spec.sync, seed=m.phase_seed(spec.seed, i)))
    return out


def stage_seconds(m, spec, source, traces):
    """Host seconds to stage each phase's first chunk of events (resize,
    pinned stacking, copy to the card), staged alone."""
    plane = m.DataPlane(source, seed=spec.seed, prefetch=False)
    phases = spec.to_phases()
    plane.bind(phases)
    out = []
    for i, (ph, tr) in enumerate(zip(phases, traces)):
        first = m.chunk_ranges(tr, 32)[:1]
        t0 = time.perf_counter()
        for _ in plane.trace_feed(i, ph, "cuda")(tr, first):
            torch.cuda.synchronize()
        out.append({"events": first[0][1] - first[0][0],
                    "seconds": time.perf_counter() - t0})
    plane.close()
    return out


def profile_events(m, cfg, fns, source, shapes, n: int = 8):
    """Device time of one traced event (gradient + B3 update) per
    (resolution, batch) in ``shapes``: ``n`` events on a batch already on
    the card, traced after two warm-up events."""
    from torch.profiler import ProfilerActivity, profile
    params = m.models.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cuda")
    spec = m.flat_spec(params)
    p2 = spec.ravel(params)
    vel3 = spec.zeros_stacked(N_WORKERS, device="cuda")
    out = []
    for res, bsz in shapes:
        grad_fn = fns(res)[0]
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in source.batch_at(list(range(bsz)), res).items()}

        def event():
            g = spec.ravel(grad_fn(spec.unravel(p2), batch))
            with torch.no_grad():
                m.K.dbl_apply_worker_flat2d(p2, g, vel3, WID, 1e-4, FACTOR,
                                            MOM)
        for _ in range(2):
            event()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                event()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy_us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA)
        out.append({"input_size": res, "batch": bsz,
                    "ms_per_event": 1e3 * wall / n,
                    "device_busy_ms_per_event": busy_us / 1e3 / n,
                    "device_idle_share": 1.0 - busy_us / 1e6 / wall})
        log(f"  event profile {res} px x {bsz} images (staged): "
            f"{out[-1]['ms_per_event']:.2f} ms/event, device busy "
            f"{out[-1]['device_busy_ms_per_event']:.2f} ms "
            f"(idle {out[-1]['device_idle_share']:.0%})")
    return out


def param_gap(m, a, b) -> float:
    return max(float((x.float() - y.float().to(x.device)).abs().max())
               for x, y in zip(m.tree_leaves(a), m.tree_leaves(b)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: no src/repro_torch beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from dataclasses import replace
    from types import SimpleNamespace

    from repro_torch import api, models
    from repro_torch.configs import get_config
    from repro_torch.core.flat import padded_rows
    from repro_torch.data import DataPlane, SyntheticImages
    from repro_torch.engine import TrainEngine
    from repro_torch.kernels import _build
    from repro_torch.kernels import dbl_merge as K
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.optim import sgd_momentum
    from repro_torch.cluster import schedule_pass, workers_from_plan
    from repro_torch.cluster.backend import phase_seed, scaled_time_model
    from repro_torch.cluster.trace import _chunk_ranges
    from repro_torch.core.flat import flat_spec
    from repro_torch.examples.train_resnet18_e2e import make_fns_factory
    m = SimpleNamespace(api=api, models=models, TrainEngine=TrainEngine,
                        sgd_momentum=sgd_momentum, K=K,
                        tree_leaves=tree_leaves, DataPlane=DataPlane,
                        schedule_pass=schedule_pass,
                        workers_from_plan=workers_from_plan,
                        phase_seed=phase_seed,
                        scaled_time_model=scaled_time_model,
                        chunk_ranges=_chunk_ranges, flat_spec=flat_spec)
    report = {}

    # 1. device + build
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    build_s = _build.build_all()
    log(f"kernel build (nvcc, {len(list(_build.CSRC.glob('*.cu')))} "
        f"source(s) in parallel): {build_s:.2f} s")
    report.update(device=name, nvidia_smi=smi, build_s=build_s)
    rate = mem_rate(name)

    # 2. kernels at the full ResNet-18 flat-store shape
    cfg = get_config("cifar-resnet18")
    meta = models.init_params(cfg, torch.Generator().manual_seed(0),
                              device="meta")
    n_live = sum(t.numel() for t in tree_leaves(meta))
    rows = padded_rows(n_live)
    log(f"kernels: full ResNet-18 store, {n_live} live elements, "
        f"{rows} x 128 f32")
    kernels = kernel_phase(K, rows, rate)

    # 3. the main path
    source = SyntheticImages(n_train=8192, num_classes=100)
    spec = _spec(api)
    torch.cuda.reset_peak_memory_stats()
    run = drive(m, spec, cfg, device="cuda", source=source)
    launches, losses = run["launches"], run["losses"]
    if launches["dbl_apply_flat2d"]["plain"] != spec.n_steps \
            or run["total"] != spec.n_steps \
            or run["plain_runs"]:
        raise AssertionError(f"main path launches {launches}, plain runs "
                             f"{run['plain_runs']}: expected one "
                             "dbl_apply_flat2d launch per step and no plain "
                             "version")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    peak = torch.cuda.max_memory_allocated()
    # images/s counts the examples a step trains on (the large group's
    # rows and the small group's valid rows), not the padded batch
    phases = [{"input_size": p["input_size"], "batch": p["batch_size"],
               "examples": ph.layout.effective_examples,
               "steps": p["steps"], "time_s": p["time"],
               "ms_per_step": 1e3 * p["time"] / p["steps"],
               "images_per_s": ph.layout.effective_examples * p["steps"]
               / p["time"]}
              for p, ph in zip(run["res"].phases, spec.to_phases())]
    log(f"main path: {len(losses)} steps in {run['wall_s']:.2f} s; peak "
        f"memory {peak / 2**30:.2f} GiB; time to first step per phase "
        f"{[s['stall_s'] for s in run['stalls']]} s")
    for p in phases:
        log(f"  phase {p['input_size']} px x {p['steps']} steps at batch "
            f"{p['batch']} ({p['examples']:.0f} examples): "
            f"{p['ms_per_step']:.1f} ms/step, {p['images_per_s']:.0f} "
            "images/s")
    log(f"  losses: {losses}")
    report["main_path"] = {"wall_s": run["wall_s"], "peak_bytes": peak,
                           "phases": phases, "losses": losses,
                           "launches": launches, "stalls": run["stalls"]}
    # launches per kernel and variant, summed over the counts read after
    # each path run (main path and the short runs below)
    path_launches = {k: dict(v) for k, v in launches.items()}

    # 4. the other variants through the engine, 4 full-width steps each
    short = [("dbl_apply_flat2d", "vel", {"server_momentum": MOM}, "f32"),
             ("dbl_apply_flat2d", "master", {}, "bf16"),
             ("dbl_apply_flat2d", "master_vel", {"server_momentum": MOM},
              "bf16"),
             ("dbl_merge_flat2d", "plain", {"scan_loop": False}, "f32")]
    report["short_runs"] = []
    for kernel, variant, ekw, prec in short:
        r = drive(m, _spec(api, n_steps=4), cfg, device="cuda",
                  source=source, engine_kw=ekw, precision=prec)
        if r["launches"][kernel][variant] != 4 or r["total"] != 4 \
                or r["plain_runs"]:
            raise AssertionError(f"{kernel}[{variant}] run: launches "
                                 f"{r['launches']}, plain runs "
                                 f"{r['plain_runs']}")
        for k, per in r["launches"].items():
            for v, c in per.items():
                path_launches[k][v] += c
        log(f"{kernel}[{variant}] path ({ekw or ''} {prec}): 4 launches, "
            f"losses {r['losses']}, {r['wall_s']:.2f} s")
        report["short_runs"].append({"kernel": kernel, "variant": variant,
                                     "engine": ekw, "precision": prec,
                                     "losses": r["losses"],
                                     "wall_s": r["wall_s"]})

    # 5. parity on a small input: the card against the CPU port
    small = replace(cfg, d_model=8, vocab_size=10)
    sspec = _spec(api, batch_size=16, dataset_size=256, n_steps=6,
                  sub_dropouts=(0.0, 0.0), stage_epochs=(2,),
                  stage_lrs=(0.005,), tm_a=1.0, tm_b=24.6)
    ssrc = SyntheticImages(n_train=256, n_test=32, num_classes=10, seed=0)
    p0 = models.init_params(small, torch.Generator().manual_seed(0),
                            device="cpu")
    runs = {leg: drive(m, sspec, small, device="cuda", source=ssrc,
                       params=tree_map(lambda t: t.cuda(), p0),
                       tf32=leg == "tf32")
            for leg in ("card", "tf32")}
    # one CPU thread: multi-threaded oneDNN conv backward has aborted the
    # process on small ResNets (and the CPU tests run it so too)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu = drive(m, sspec, small, device="cpu", source=ssrc,
                    params=tree_map(lambda t: t.clone(), p0))
    finally:
        torch.set_num_threads(threads)

    def gaps(r):
        """(largest loss gap, largest param gap) of a card run vs the CPU;
        the losses are the history's, rounded to 4 decimals."""
        return (max(abs(a - b) for a, b in zip(r["losses"], cpu["losses"])),
                max(float((a.cpu() - b).abs().max()) for a, b in
                    zip(tree_leaves(r["res"].params),
                        tree_leaves(cpu["res"].params))))
    report["parity"] = {}
    for leg, r in runs.items():
        loss_gap, pgap = gaps(r)
        inside = loss_gap <= PARITY_BAND["loss"] and \
            pgap <= PARITY_BAND["params"]
        report["parity"][leg] = {"loss_gap": loss_gap, "param_gap": pgap,
                                 "inside_band": inside}
        log(f"parity (width 8, lr 0.005, 6 steps), {leg} vs CPU: loss gap "
            f"{loss_gap:.3g}, param gap {pgap:.3g} (bands "
            f"{PARITY_BAND['loss']:g} / {PARITY_BAND['params']:g}): "
            f"{'inside' if inside else 'outside'}")
    if not report["parity"]["card"]["inside_band"]:
        raise AssertionError("the card and the CPU port disagree")

    report["profile"] = profile_rungs(m, cfg, _spec(api), source,
                                      PROFILE_STEPS)

    # 7. the PS simulator's main path: the traced replay at full width,
    # one B3 launch per event
    ps_spec = api.ScheduleSpec(**PS_SPEC)
    ps_src = SyntheticImages(n_train=2048, n_test=512, num_classes=100)
    ps_fns = make_fns_factory(cfg, ps_src, "cuda")
    traces = phase_traces(m, ps_spec)
    n_events = sum(t.n_events for t in traces)
    tr = drive_ps(m, ps_spec, cfg, ps_fns, ps_src, traced=True)
    if n_events != PS_EVENTS or tr["launches"][WORKER]["plain"] != n_events \
            or tr["total"] != n_events or tr["plain_runs"]:
        raise AssertionError(f"PS-sim main path: {n_events} events, "
                             f"launches {tr['launches']}, plain runs "
                             f"{tr['plain_runs']}: expected {PS_EVENTS} "
                             f"{WORKER}[plain] launches and nothing else")
    ps_phases = []
    for rec, t, p in zip(tr["records"], traces, tr["res"].phases):
        if not rec["events"] == t.n_events == p["steps"]:
            raise AssertionError(f"phase {rec} ran {p['steps']} events, "
                                 f"its trace holds {t.n_events}")
        images = int(t.batch_size.sum())
        ps_phases.append({
            "input_size": p["input_size"], "events": t.n_events,
            "batch_sizes": list(t.sizes), "images": images,
            "wall_s": rec["wall_s"], "stall_s": rec["stall_s"],
            "ms_per_event": 1e3 * rec["wall_s"] / t.n_events,
            "images_per_s": images / rec["wall_s"]})
    staging = stage_seconds(m, ps_spec, ps_src, traces)
    log(f"PS-sim main path (traced, full width): {n_events} events, "
        f"{tr['launches'][WORKER]['plain']} {WORKER}[plain] launches, "
        f"{tr['wall_s']:.2f} s; peak memory {tr['peak'] / 2**30:.2f} GiB; "
        f"test losses {tr['losses']}")
    for p, st in zip(ps_phases, staging):
        log(f"  phase {p['input_size']} px: {p['events']} events "
            f"(batches {p['batch_sizes']}), {p['ms_per_event']:.1f} "
            f"ms/event, {p['images_per_s']:.0f} images/s, first event after "
            f"{p['stall_s']:.3f} s; staging its first chunk of "
            f"{st['events']} events alone: {st['seconds']:.3f} s")
    ev_prof = profile_events(m, cfg, ps_fns, ps_src, [(24, 113), (32, 64)])
    path_launches[WORKER]["plain"] = tr["launches"][WORKER]["plain"]

    # 8. the event path on the same spec (no B3), and the traced replay
    # once more, warm
    ev = drive_ps(m, ps_spec, cfg, ps_fns, ps_src, traced=False)
    if ev["total"] or ev["plain_runs"]:
        raise AssertionError(f"event path launched {ev['launches']}")

    def timeline(r):
        return ([p["steps"] for p in r["res"].phases], r["res"].time,
                [(h["epoch"], h["sim_time"]) for h in r["res"].history])
    if timeline(ev) != timeline(tr):
        raise AssertionError(f"event path timeline {timeline(ev)} != traced "
                             f"{timeline(tr)}")
    tr2 = drive_ps(m, ps_spec, cfg, ps_fns, ps_src, traced=True)
    ev_gap = param_gap(m, ev["res"].params, tr["res"].params)
    tr_gap = param_gap(m, tr2["res"].params, tr["res"].params)
    log(f"PS-sim event path: {ev['wall_s']:.2f} s (traced, warm: "
        f"{tr2['wall_s']:.2f} s), per phase "
        f"{[round(r['wall_s'], 3) for r in ev['records']]} s vs "
        f"{[round(r['wall_s'], 3) for r in tr2['records']]} s; timeline "
        f"equal; param gap to the traced run {ev_gap:.3g} (band "
        f"{EVENT_BAND:g}), traced run vs traced run {tr_gap:.3g}")
    if ev_gap > EVENT_BAND:
        raise AssertionError(f"event path {ev_gap} from the traced replay")
    # the same runs on cuDNN's deterministic kernels: the traced replay
    # must repeat itself, and the event path match it, bit for bit
    torch.backends.cudnn.deterministic = True
    try:
        det = {leg: drive_ps(m, ps_spec, cfg, ps_fns, ps_src,
                             traced=leg != "event")
               for leg in ("traced", "traced_again", "event")}
    finally:
        torch.backends.cudnn.deterministic = False
    det_repeat = param_gap(m, det["traced_again"]["res"].params,
                           det["traced"]["res"].params)
    det_gap = param_gap(m, det["event"]["res"].params,
                        det["traced"]["res"].params)
    log(f"PS-sim on deterministic cuDNN: traced {det['traced']['wall_s']:.2f}"
        f" / {det['traced_again']['wall_s']:.2f} s, event "
        f"{det['event']['wall_s']:.2f} s; traced vs traced param gap "
        f"{det_repeat:.3g}, event vs traced {det_gap:.3g}")
    if det_repeat != 0.0 or det_gap != 0.0:
        raise AssertionError("on deterministic cuDNN the traced replay does "
                             "not repeat itself, or the event path differs "
                             "from it")

    # 9. the bf16 store through the traced replay: B3's master form
    bspec = api.ScheduleSpec(**BF16_SPEC)
    nb = sum(t.n_events for t in phase_traces(m, bspec))
    bf = drive_ps(m, bspec, cfg, ps_fns, ps_src, traced=True,
                  precision="bf16")
    if bf["launches"][WORKER]["master"] != nb or bf["total"] != nb \
            or bf["plain_runs"]:
        raise AssertionError(f"bf16 run: {nb} events, launches "
                             f"{bf['launches']}")
    path_launches[WORKER]["master"] = nb
    log(f"PS-sim bf16 (traced, dbl): {nb} {WORKER}[master] launches, "
        f"{bf['wall_s']:.2f} s, test losses {bf['losses']}")

    # 10. the traced PS-sim on the card against the CPU port, width 8; the
    # card leg starts with TF32 on, which the backend must turn off
    sspec = api.ScheduleSpec(**PS_SMALL_SPEC)
    ssrc = SyntheticImages(n_train=128, n_test=16, num_classes=10, seed=0)
    p0 = models.init_params(small, torch.Generator().manual_seed(0),
                            device="cpu")
    card = drive_ps(m, sspec, small, make_fns_factory(small, ssrc, "cuda"),
                    ssrc, traced=True, params=tree_map(lambda t: t.cuda(), p0),
                    tf32=True)
    torch.set_num_threads(1)
    try:
        cpu_ps = drive_ps(m, sspec, small,
                          make_fns_factory(small, ssrc, "cpu"), ssrc,
                          traced=True, device="cpu",
                          params=tree_map(lambda t: t.clone(), p0))
    finally:
        torch.set_num_threads(threads)
    ps_loss_gap = max(abs(a - b) for a, b in zip(card["losses"],
                                                 cpu_ps["losses"]))
    ps_pgap = param_gap(m, card["res"].params, cpu_ps["res"].params)
    log(f"PS-sim parity (width 8, 4 -> 8 px, 16 events), card vs CPU: loss "
        f"gap {ps_loss_gap:.3g}, param gap {ps_pgap:.3g} (bands "
        f"{PS_PARITY_BAND['loss']:g} / {PS_PARITY_BAND['params']:g})")
    if ps_loss_gap > PS_PARITY_BAND["loss"] or \
            ps_pgap > PS_PARITY_BAND["params"]:
        raise AssertionError("the card and the CPU port disagree on the "
                             "PS simulator")
    report["ps_sim"] = {
        "main_path": {"wall_s": tr["wall_s"], "peak_bytes": tr["peak"],
                      "phases": ps_phases, "staging": staging,
                      "test_losses": tr["losses"],
                      "launches": tr["launches"]},
        "event_profile": ev_prof,
        "event_path": {"wall_s": ev["wall_s"], "records": ev["records"],
                       "test_losses": ev["losses"], "param_gap": ev_gap},
        "traced_again": {"wall_s": tr2["wall_s"], "records": tr2["records"],
                         "param_gap": tr_gap},
        "deterministic": {leg: {"wall_s": r["wall_s"],
                                "test_losses": r["losses"]}
                          for leg, r in det.items()}
        | {"repeat_gap": det_repeat, "event_gap": det_gap},
        "bf16": {"events": nb, "wall_s": bf["wall_s"],
                 "test_losses": bf["losses"]},
        "parity": {"loss_gap": ps_loss_gap, "param_gap": ps_pgap}}

    # the kernels line: per kernel, the variant its main path runs, with
    # every variant's numbers beside it
    line = []
    for kernel, (fn_line, table) in KERNEL_INFO.items():
        recs = [r for k, _, r in kernels if k == kernel]
        main = recs[0]                               # "plain"
        for r in recs:
            r["launches"] = path_launches[kernel][r["variant"]]
        line.append({
            "name": kernel, "route": "cuda", "source": CSRC,
            "replaces": f"{REFERENCE}:{fn_line}",
            "launches": main["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "variants": recs})
    report["kernels"] = line
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
