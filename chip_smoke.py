#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each of which raises (and so exits non-zero) on any failure:

1. device: the card's name and power limit, and the build of the port's
   CUDA kernels from ``src/repro_torch/csrc`` (nvcc, at first use);
2. kernels: every variant of ``dbl_apply_flat2d`` (B1) and
   ``dbl_merge_flat2d`` (B2), on N(0, 1) inputs from a seeded generator
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
6. profile: where a step's time goes per CPL rung (``profile_rungs``).

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

# per variant: (reference inner kernel line, bytes per element, f32 ops
# per element) — each input read once, each output written once
B1 = {"plain": (87, 12, 2), "vel": (93, 20, 4), "master": (132, 14, 2),
      "master_vel": (141, 22, 4)}
B2 = {"plain": (68, 16, 5), "vel": (76, 24, 7), "master": (106, 18, 5),
      "master_vel": (118, 26, 7)}
KERNEL_INFO = {"dbl_apply_flat2d": (229, B1), "dbl_merge_flat2d": (186, B2)}

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
def _buffers(rows, variant, merge, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda: torch.randn(rows, 128, generator=gen, device="cuda")
    bufs = {"w": rnd(), "g": rnd()}
    if merge:
        bufs["gs"] = rnd()
    if "vel" in variant:
        bufs["v"] = rnd()
    if "master" in variant:
        bufs["shadow"] = bufs["w"].to(torch.bfloat16)
    return bufs


def _call(K, kernel, variant, b, plain: bool):
    """One update of ``b`` in place, by the kernel or its plain version."""
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
    ref = _buffers(rows, variant, kernel == "dbl_merge_flat2d", seed)
    plain = {k: t.clone() for k, t in ref.items()}
    _call(K, kernel, variant, ref, plain=False)
    _call(K, kernel, variant, plain, plain=True)
    torch.cuda.synchronize()
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
    launches = {k: {v: m.K.launch_count(k, v) for v in m.K.VARIANTS}
                for k in m.K.KERNELS}
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
    m = SimpleNamespace(api=api, models=models, TrainEngine=TrainEngine,
                        sgd_momentum=sgd_momentum, K=K,
                        tree_leaves=tree_leaves, DataPlane=DataPlane)
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
