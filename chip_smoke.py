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
   is one (and, paired, in turns with it: kernel, library, library,
   kernel, three times), and the least time the card could take (bytes
   moved over the memory rate);
3. main path: ``repro_torch.api.run`` on the hybrid dual-batch x CPL
   schedule at the full width of ``cifar-resnet18`` (stem 64, 100
   classes, 24 -> 32 px, global batch 512 at 32 px, 40 steps): one B1
   launch per step, parameters on the card, finite and falling loss;
4. other paths: 4 full-width steps each with server momentum, the bf16
   store (with and without momentum) and the per-step loop (B2), each
   with its own launch count;
5. parity: the same schedule at width 8 on the card and on the CPU (the
   CPU port is what the repository's tests hold against the JAX package),
   the CPU run taking every ReLU kink on the side the card's run took
   (``ReluSides``), within ``PARITY_BAND``; a second card run with TF32
   turned back on, against its own kink-matched CPU run, must land
   outside the band (a planted precision fault);
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
    ``PS_PARITY_BAND``;
11. decode kernels: ``flash_decode`` (B5) and ``flash_decode_paged`` (B6)
    against their plain versions (``FD_F32_TOL``; bf16 outputs one bf16
    ulp more) at the phi3-mini and gemma3-4b geometries and the reduced
    shapes of the CPU tests, q and cache each in f32 and bf16, with a
    scrambled page table, a dead sentinel row and the windows of
    ``FD_SHAPES``; each timed at its first window beside its plain
    version, its library call (SDPA for B5; for B6 none, with gather +
    SDPA as a note) and its bytes bound, f32 and bf16 pages side by side;
    B6 also at every cluster size of ``CLUSTER_SIZES`` (checked at every
    shape, timed at the two full geometries);
12. serving main path: ``ServeEngine(backend="paged")`` on
    ``phi3-mini-3.8b`` at full width (32 layers, bf16 params, f32 pages,
    weights from a seeded generator on the card) serving the 16 requests
    of ``SERVE_WORKLOAD``: one B6 launch per layer per decode tick and no
    plain attention at T = 1, tokens in the vocabulary, finite logits,
    the schedule ``run_serve_loop`` gives with stub hooks; tok/s, TTFT,
    TPOT, ms per decode tick, a profile of ``PROFILE_TICKS`` (B6's share,
    device idle share, top kernels) and peak memory; the contiguous
    backend on the same requests (token agreement reported, not
    asserted: bf16 logits can tie);
13. serving parity: reduced gemma3-4b (window 16) and phi3-mini in f32 on
    the card against the CPU port on the churn workload, tokens identical
    and logits within ``SERVE_PARITY_BAND``; on the card, speculative
    decode (k = 3) and prefix sharing token-identical to one-token decode;
14. attention and scan kernels: ``flash_attention`` (B4),
    ``mamba_ssd_scan`` (B7) and ``wkv6_chunked`` (B8) against their plain
    versions (``PF_F32_TOL``; bf16 outputs one bf16 ulp more) in f32 and
    bf16 at the model geometries of
    ``FA_SHAPES`` / ``SSD_SHAPES`` / ``WKV_SHAPES`` (zamba2-2.7b's shared
    attention and SSD — the SSD also on the strided views ``mamba2_block``
    passes — phi3-mini-3.8b's and gemma3-4b's attention, rwkv6-7b's WKV,
    also in the model's form: bf16 views of r, k, v, an f32 decay and an
    f32 output, as ``time_mix`` passes them — all at 2 x 2048 tokens), a
    strong-decay WKV (w down to 1e-20) and the reduced, ragged and sweep
    shapes of the CPU tests (B8's bf16 cases keep w in f32, as the card's
    kernel takes it); each timed at its model geometries beside its plain
    version, its library call (SDPA for B4; none for B7 and B8) and its
    bound (operations over the rate of the units the form runs on — 989
    TFLOP/s of bf16 tensor cores for the bf16 forms of B4, B7 and B8, 67
    TFLOP/s of f32 otherwise — or bytes over the memory rate, the larger);
15. prefill main path: ``launch.steps.make_prefill_step`` at full width in
    bf16 (weights from a seeded generator on the card) on 2 x 2048 random
    tokens, zamba2-2.7b (45 B7 and 9 B4 launches a forward) then
    rwkv6-7b (32 B8), no plain runs, finite (2, vocab) logits; ms per
    prefill, tokens/s, a profile of one prefill (device idle share, top
    kernels, B4 / B7 / B8 shares, the copy kernels' time) and peak memory;
16. prefill parity: reduced f32 zamba2-2.7b (6 layers), rwkv6-7b,
    gemma3-4b (window 16) and phi3-mini-3.8b on the card (B4 / B7 / B8)
    against the CPU port (the reference's scans), within
    ``PREFILL_PARITY_BAND``;
17. ``kernels/ops.py``: each front end once on the card, one launch of its
    kernel, against the plain version;
18. LM training main path: B1 (plain) at the flat-store shape of
    full-width ``phi3-mini-3.8b`` (29.85 M x 128 f32, past 2^31 elements)
    bit-equal to its plain version (run a slice at a time) and timed
    beside ``add_`` and its bytes bound; then ``launch.train.run`` on
    ``LM_ARGV`` (full width, bf16 params, block remat, hybrid dual-batch x
    CPL at seq 64 -> 128, fused SGD, 40 steps; logged every step rather
    than every 20th): one B1 launch a step and no B4 / B7 / B8 (the
    training forward runs the differentiable scans), both sequence
    lengths, finite losses, the last below the first, params on the card;
    per sub-stage ms per step, tokens/s and time to its first step, peak
    memory, and one profiled step per sub-stage (CUDA events around the
    step; device idle share, top kernels, B1's share);
19. LM training parity and resume: reduced f32 phi3-mini, gemma3-4b
    (window 16), zamba2-2.7b (6 layers) and rwkv6-7b, 4 dual-batch steps
    each in the fused (B1), per-step (B2) and weighted AdamW forms, on the
    card against the CPU port on the same init and data, within
    ``TRAIN_PARITY_BAND``; then reduced phi3-mini through the CLI with
    ``--ckpt`` over both phases and ``--resume`` from the middle boundary,
    the final checkpoints equal bit for bit;
20. the autotuner: (a) B3's candidate-batched form
    (``dbl_apply_worker_batched``, f32 and master, C = 1 and 3 candidates
    with distinct lr / factor / momentum) bit-equal to its plain version
    and to C one-store B3 launches at 64 and 3072 rows and the full store,
    only row block (c, wid) of each velocity changed, timed at C = 3 beside
    three B3 launches, its plain version and its bytes bound; (b) the
    tuner's main path: ``tune.autotune(combined_space(epochs=4), ...,
    budget_ratio=1.5)`` on full-width ``cifar-resnet18`` (the repo's PS
    problem cut from 16 to 4 epochs), started with TF32 on: k1.5 pruned,
    base / f_sqrt / f_none replayed as one batched group (one batched
    launch an event), six candidates through ``api.run`` (one B3 launch an
    event, counted from their traces), no plain run, TF32 off at every
    gradient, finite accuracies, a front, the analytic run's run_key;
    wall seconds a replay and peak memory; (c) that group again, batched
    and each candidate through ``execute_trace``, on cuDNN's deterministic
    kernels: the same params bit for bit; (d) a search with
    ``combined_space``'s axes at width 8 on 8 px on the card and on the CPU
    port: the same labels, pruning, replay tags and sim_times, every
    evaluation's loss and params within ``PS_PARITY_BAND``.

The launch counts are set to 0 just before each path and read just after;
the ``launches`` in the kernels line are those counts, summed over the
main path and the short runs (for B1 and B2, the engine runs of phases 3-4
and the LM runs of phases 18-19 on the card; for B5 and B6, the paged
serving main path's timed run; B5 has no caller on that path, so its count
is 0; for B4, B7 and B8, one forward of each model of phase 15; B3 adds
phase 20's search, its one-store and batched launches, the batched form's
records among its variants).  Launches
made to compare a kernel with its plain version are not counted.  B1's
numbers in the line are its LM-store ones (phase 18), the shape this
slice's main path gives it; the ResNet-store records stay among its
variants.
The last three lines of standard output are the card's name and power
limit (as ``nvidia-smi`` gives them), one JSON object with the kernels'
numbers, and ``{"ok": true, "device": {...}}``.
"""
import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

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

# card vs CPU port on the width-8 schedule at lr 0.005.  The losses are
# the history's, rounded to 4 decimals, so one rounding unit (1e-4) can
# separate two equal runs.  Run free, the 6 steps are ill-conditioned at
# the ReLUs: the CPU port from params 2e-7 (relative) apart lands up to
# 1.41e-3 off on the params and 3.8e-3 on the loss, past the band in 18
# of 64 draws, farther than TF32 or an lr 1 % off moves it.  With the
# second run taking the first's side at every kink (``ReluSides``) the
# same draws stay within 8.34e-7 and 0, and those two faults land at
# 3.0e-5 / 4.7e-5 (tests/test_torch_parity_kinks.py, on a CPU).
PARITY_BAND = {"loss": 1.5e-4, "params": 1e-5}
# phase 5's schedule (``_spec`` plus these) and data, at width 8
PARITY_SPEC = dict(batch_size=16, dataset_size=256, n_steps=6,
                   sub_dropouts=(0.0, 0.0), stage_epochs=(2,),
                   stage_lrs=(0.005,), tm_a=1.0, tm_b=24.6)
PARITY_SOURCE = dict(n_train=256, n_test=32, num_classes=10, seed=0)


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


def traced_kernels(run, want=(), launches=None, tries: int = 3):
    """Device kernels of one ``run()`` under ``torch.profiler`` (device
    activity only): ({kernel name: us}, {kernel name: launches}, wall
    seconds of the run).  The profiler now and then drops device events,
    all of a window's or some; a window with no kernel whose name holds
    one of ``want`` (with no device event at all where ``want`` is empty),
    or, where ``launches`` is given, with another count of such kernels, is
    traced again, up to ``tries`` times.  The last window is returned,
    whole or not."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern, count = {}, {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                kern[ev.name] = kern.get(ev.name, 0.0) + \
                    ev.time_range.elapsed_us()
                count[ev.name] = count.get(ev.name, 0) + 1
        got = sum(c for n, c in count.items()
                  if not want or any(k in n for k in want))
        if got and (launches is None or got == launches):
            break
    return kern, count, wall


def device_ms(fn, n: int = 20, groups: int = 5) -> float:
    """Device milliseconds per call of ``fn``: CUDA events around ``n``
    calls that the host queues while a sleep kernel holds the stream, so
    that the card runs them back to back and never waits for the host (the
    gaps ``cuda_ms`` still counts at a 50-70 us kernel); median over
    ``groups``.  A group in which the sleep ended before the host had
    queued every call is run again with a longer sleep."""
    fn()
    torch.cuda.synchronize()
    cycles, times = 1 << 24, []
    while len(times) < groups:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        queued_in_time = not a.query()
        b.synchronize()
        if queued_in_time:
            times.append(a.elapsed_time(b) / n)
        elif cycles >= 1 << 32:
            raise RuntimeError("the host cannot queue the calls within the "
                               "longest sleep")
        else:
            cycles *= 2
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
            paired = None
            if lib is not None:
                # kernel and library call in turns (k, l, l, k) x 3, each
                # a cuda_ms median, so that drift lands on both alike
                kern = lambda: _call(K, kernel, variant, ref, plain=False)
                turns = [(f, cuda_ms(f)) for _ in range(3)
                         for f in (kern, lib, lib, kern)]
                paired = {
                    "kernel_ms": statistics.median(
                        t for f, t in turns if f is kern),
                    "library_ms": statistics.median(
                        t for f, t in turns if f is lib)}
            bound_ms = max(n * nbytes / rate, n * nops / F32_RATE) * 1e3
            rec = {"variant": variant, "replaces": f"{REFERENCE}:{line}",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": "bytes"
                   if n * nbytes / rate >= n * nops / F32_RATE
                   else "operations", "library_ms": library_ms,
                   "paired": paired, "bytes": n * nbytes}
            out.append((kernel, fn_line, rec))
            log(f"  {kernel}[{variant}]: bit-equal to plain at "
                f"{CHECK_ROWS + (rows,)} rows; kernel "
                f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
                f"library {'-' if library_ms is None else f'{library_ms * 1e3:.1f} us'}"
                f", bound {bound_ms * 1e3:.1f} us "
                f"({bound_ms / ms:.0%} of the memory roofline)")
            if paired is not None:
                log(f"    paired (kernel, library, library, kernel) x 3: "
                    f"kernel {paired['kernel_ms'] * 1e3:.2f} us, library "
                    f"{paired['library_ms'] * 1e3:.2f} us "
                    f"({paired['kernel_ms'] / paired['library_ms']:.3f} x)")
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


class ReluSides:
    """The side of its kink that every ReLU unit of ``models.resnet`` took
    in one run (``record``), and a later run that takes each unit to the
    recorded side (``replay``: ``z * mask`` in place of ``relu(z)``), so
    that the two differ by their rounding alone.  An input within rounding
    of 0 lands on the side its device's order of sums gives it, and on a
    ReLU network the step's gradient jumps there; ``other_side`` counts the
    units the replayed run would have taken to the other side."""

    def __init__(self):
        self.masks, self.replayed, self.other_side = [], 0, 0

    @staticmethod
    def _install(resnet, relu):
        class Functional:
            def __getattr__(self, name):
                return relu if name == "relu" else getattr(F, name)
        saved, resnet.F = resnet.F, Functional()
        return saved

    def record(self, resnet, run):
        def relu(z):
            self.masks.append((z > 0).cpu())
            return F.relu(z)
        saved = self._install(resnet, relu)
        try:
            return run()
        finally:
            resnet.F = saved

    def replay(self, resnet, run):
        self.replayed = self.other_side = 0

        def relu(z):
            if self.replayed == len(self.masks):
                raise AssertionError("the replayed run calls a ReLU more "
                                     "often than the recorded run did")
            mask = self.masks[self.replayed].to(z.device)
            if mask.shape != z.shape:
                raise AssertionError(f"ReLU call {self.replayed}: recorded "
                                     f"{tuple(mask.shape)}, now "
                                     f"{tuple(z.shape)}")
            self.replayed += 1
            self.other_side += int(((z > 0) != mask).sum())
            return z * mask.to(z.dtype)
        saved = self._install(resnet, relu)
        try:
            out = run()
        finally:
            resnet.F = saved
        if self.replayed != len(self.masks):
            raise AssertionError(f"the replayed run called {self.replayed} "
                                 f"ReLUs, the recorded one {len(self.masks)}")
        return out


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
        kern, _, wall = traced_kernels(
            lambda: engine.run([short], params, None, feed))
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

        def events():
            for _ in range(n):
                event()
        kern, _, wall = traced_kernels(events)
        busy_us = sum(kern.values())
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


# ------------------------------ phases 11-14: serving -------------------------
FD_CSRC = "src/repro_torch/csrc/flash_decode.cu"
FD_REFERENCE = "src/repro/kernels/flash_decode.py"
FD_INFO = {"flash_decode": 99, "flash_decode_paged": 192}
# (label, rows, heads, kv heads, hd, page_len, pages per slot, pages, longest
# length, windows): phi3-mini and gemma3-4b at full geometry, and the
# reduced shapes of tests/test_torch_serve.py.  Each row of a table gets
# its own pages (a permutation of the pool); row 1 is dead (every entry the
# sentinel id n_pages, length 0).
FD_SHAPES = (("phi3-mini-3.8b", 8, 32, 32, 96, 16, 64, 512, 1023, (0, 64)),
             ("gemma3-4b", 8, 8, 4, 256, 16, 128, 1024, 2047, (1024,)),
             ("gemma3-4b-reduced", 2, 4, 2, 64, 16, 4, 8, 63, (16,)),
             ("phi3-mini-3.8b-reduced", 2, 4, 4, 64, 16, 4, 8, 63, (0,)))
# kernel against plain: f32 outputs within 2e-5 (the two sum the softmax in
# other orders, with other exp); bf16 outputs within one bf16 ulp of the
# larger magnitude plus that 2e-5 — both round f32 values that differ by up
# to 2e-5, and each rounding moves a value by at most half an ulp.  The
# 2e-5 matters only near zero, where the outputs (averages of ~1000 N(0, 1)
# values) cancel and the two f32 results can round two bf16 ulps apart.
FD_F32_TOL = 2e-5
# the full-width serving path (section 5 of PERF.md): phi3-mini at full
# width, bf16 params, f32 pages
SERVE_ARCH = "phi3-mini-3.8b"
SERVE_SPEC = dict(page_len=16, pages_per_slot=32, n_slots=8)
SERVE_CHUNK = 64
SERVE_WORKLOAD = dict(prompt_lens=(16, 256), gen_short=(16, 32),
                      gen_long=(96, 128), p_long=0.25)
SERVE_REQUESTS = 16
PROFILE_TICKS = 10               # full (8-row) decode ticks profiled
# card vs CPU on the reduced configs, f32, the churn workload of
# tests/test_serve.py: greedy tokens identical, logits within this band
# (measured 4.9e-6 / 5.1e-6 for gemma3 / phi3 on NVIDIA H100 80GB HBM3,
# 700 W — the port's CPU lies 5.4e-6 from the JAX package on the same runs)
SERVE_PARITY_BAND = 5e-5


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |x| (8 significant bits)."""
    a = x.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _fd_inputs(shape, q_dtype, kv_dtype, seed):
    """One shape's paged inputs on the card, and the contiguous caches of
    the same keys (B5's layout), from a seeded numpy / torch draw."""
    import numpy as np
    _, rows, h, kvh, hd, page_len, pp, n_pages, max_len, _ = shape
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = rng.permutation(n_pages)[:rows * pp].reshape(rows, pp) \
        .astype(np.int32)
    lengths = rng.integers(0, max_len + 1, rows).astype(np.int32)
    lengths[0] = max_len
    table[1], lengths[1] = n_pages, 0                    # the dead row
    q = torch.randn(rows, h, 1, hd, generator=gen, device="cuda") \
        .to(q_dtype)
    kp = torch.randn(n_pages, page_len, kvh, hd, generator=gen,
                     device="cuda").to(kv_dtype)
    vp = torch.randn(n_pages, page_len, kvh, hd, generator=gen,
                     device="cuda").to(kv_dtype)
    tbl = torch.from_numpy(table).cuda()
    lens = torch.from_numpy(lengths).cuda()
    gather = tbl.long().clamp(0, n_pages - 1)
    kc = kp[gather].reshape(rows, pp * page_len, kvh, hd).transpose(1, 2) \
        .contiguous()
    vc = vp[gather].reshape(rows, pp * page_len, kvh, hd).transpose(1, 2) \
        .contiguous()
    return q, kp, vp, tbl, lens, kc, vc, lengths


def _live(length: int, n_keys: int, window: int) -> int:
    hi = min(length, n_keys - 1)
    lo = max(0, length - window + 1) if window > 0 else 0
    return max(0, hi - lo + 1)


def _fd_err(out, ref):
    """(max abs diff, passes, worst element): f32 within FD_F32_TOL, bf16
    within FD_F32_TOL plus one bf16 ulp, elementwise."""
    diff = (out.float() - ref.float()).abs()
    if out.dtype == torch.bfloat16:
        big = torch.maximum(out.float().abs(), ref.float().abs())
        ratio = diff / (bf16_ulp(big) + FD_F32_TOL)
        ok = bool((ratio <= 1.0).all())
    else:
        ratio = diff / FD_F32_TOL
        ok = float(diff.max()) <= FD_F32_TOL
    i = int(ratio.argmax())
    worst = (tuple(int(x) for x in
                   torch.unravel_index(torch.tensor(i), ratio.shape)),
             float(out.flatten()[i]), float(ref.flatten()[i]),
             float(ratio.flatten()[i]))
    return float(diff.max()), ok, worst


def fd_kernel_phase(FD, rate):
    """B5 and B6 against their plain versions at every shape, dtype pair
    and window of FD_SHAPES; timed (kernel, plain, library, bound) at
    each shape's first window.  Returns per-kernel lists of records."""
    out = {"flash_decode": [], "flash_decode_paged": []}
    for si, shape in enumerate(FD_SHAPES):
        label, rows, h, kvh, hd, page_len, pp, n_pages, max_len, windows = \
            shape
        n_keys = pp * page_len
        pos = max_len - 7                      # B5: one position for all
        for qd in (torch.bfloat16, torch.float32):
            for kd in (torch.float32, torch.bfloat16):
                q, kp, vp, tbl, lens, kc, vc, lengths = _fd_inputs(
                    shape, qd, kd, seed=100 + si)
                for wi, w in enumerate(windows):
                    b6 = FD.flash_decode_paged(q, kp, vp, tbl, lens, window=w)
                    r6 = FD.paged_decode_ref(q, kp, vp, tbl, lens, window=w)
                    b5 = FD.flash_decode(q, kc, vc, pos, window=w)
                    r5 = FD._xla_decode(q, kc, vc, pos, window=w)
                    torch.cuda.synchronize()
                    for name, o, r in (("flash_decode_paged", b6, r6),
                                       ("flash_decode", b5, r5)):
                        err, ok, worst = _fd_err(o, r)
                        if not ok:
                            raise AssertionError(
                                f"{name} {label} q {qd} cache {kd} window "
                                f"{w}: kernel differs from its plain "
                                f"version by {err}; worst element (index, "
                                f"kernel, plain, diff / tolerance) {worst}")
                        rec = {"shape": label, "q": str(qd)[6:],
                               "cache": str(kd)[6:], "window": w,
                               "max_abs_err": err}
                        if wi == 0:
                            rec.update(_fd_times(
                                FD, name, q, kp, vp, tbl, lens, kc, vc, pos,
                                w, lengths, n_keys, rate))
                        if name == "flash_decode_paged":
                            rec.update(_fd_splits(
                                FD, q, kp, vp, tbl, lens, w, r6, label,
                                timed=wi == 0 and si < 2))
                        out[name].append(rec)
                del q, kp, vp, tbl, lens, kc, vc
        log(f"  B5/B6 {label}: rows {rows}, heads {h}/{kvh}, hd {hd}, "
            f"{pp} pages of {page_len} per row, windows {windows}: within "
            "tolerance of the plain versions (q and cache bf16 / f32)")
        for name in out:
            for r in out[name]:
                if r["shape"] == label and "split_ms" in r:
                    d = r["split_device_ms"]
                    log(f"    flash_decode_paged q {r['q']} cache "
                        f"{r['cache']} by cluster size (chosen "
                        f"{r['split']}), event / device time: " + ", ".join(
                            f"{c}: {t * 1e3:.1f} / "
                            f"{d[c] * 1e3:.1f} us "
                            f"({r['bound_ms'] / d[c]:.0%} of bound)"
                            for c, t in r["split_ms"].items()))
                if r["shape"] == label and "ms" in r:
                    log(f"    {name} q {r['q']} cache {r['cache']}: kernel "
                        f"{r['ms'] * 1e3:.1f} us (device "
                        f"{r['device_ms'] * 1e3:.1f} us), plain "
                        f"{r['plain_ms'] * 1e3:.1f} us, library "
                        + ("-" if r["library_ms"] is None
                           else f"{r['library_ms'] * 1e3:.1f} us")
                        + (f" (gather + SDPA {r['gather_sdpa_ms'] * 1e3:.1f}"
                           " us)" if "gather_sdpa_ms" in r else "")
                        + f", bound {r['bound_ms'] * 1e3:.1f} us by "
                        f"{r['bound_by']} ({r['bound_ms'] / r['ms']:.0%}; "
                        f"device {r['bound_ms'] / r['device_ms']:.0%}), "
                        f"err {r['max_abs_err']:.3g}")
    torch.cuda.empty_cache()
    return out


def _fd_splits(FD, q, kp, vp, tbl, lens, w, ref, label, timed):
    """B6 at every cluster size the wrapper can choose, each against the
    plain version (within the phase's tolerance) and, where ``timed``,
    each timed; the size the wrapper chooses itself."""
    n_pages, page_len, kvh = kp.shape[:3]
    rec = {"split": FD.cluster_size(
        q.shape[0], q.shape[1], kvh, tbl.shape[1] * page_len,
        torch.cuda.get_device_properties(0).multi_processor_count,
        q.shape[3], kp.element_size())}
    times, dev = {}, {}
    for c in FD.CLUSTER_SIZES:
        call = lambda: FD.flash_decode_paged(q, kp, vp, tbl, lens, window=w,
                                             split=c)
        out = call()
        torch.cuda.synchronize()
        err, ok, worst = _fd_err(out, ref)
        if not ok:
            raise AssertionError(
                f"flash_decode_paged {label} window {w} cluster {c}: kernel "
                f"differs from its plain version by {err}; worst {worst}")
        if timed:
            times[c] = cuda_ms(call)
            dev[c] = device_ms(call)
    if timed:
        rec.update(split_ms=times, split_device_ms=dev)
    return rec


def _fd_times(FD, name, q, kp, vp, tbl, lens, kc, vc, pos, w, lengths,
              n_keys, rate):
    """Kernel, plain-version and library times of one call, and its bound:
    each live K/V byte read once, q read and the output written once."""
    rows, h, _, hd = q.shape
    kvh = kp.shape[2]
    esz = kp.element_size()
    if name == "flash_decode_paged":
        live = [_live(int(x), n_keys, w) for x in lengths]
        kern = lambda: FD.flash_decode_paged(q, kp, vp, tbl, lens, window=w)
        plain = lambda: FD.paged_decode_ref(q, kp, vp, tbl, lens, window=w)
    else:
        live = [_live(pos, n_keys, w)] * rows
        kern = lambda: FD.flash_decode(q, kc, vc, pos, window=w)
        plain = lambda: FD._xla_decode(q, kc, vc, pos, window=w)
    nbytes = sum(live) * kvh * hd * 2 * esz + 2 * q.numel() * q.element_size()
    nops = sum(live) * h * hd * 4
    bound_s = max(nbytes / rate, nops / F32_RATE)
    rec = {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
           "device_ms": device_ms(kern),
           "bound_ms": bound_s * 1e3,
           "bound_by": "bytes" if nbytes / rate >= nops / F32_RATE
           else "operations", "bytes": nbytes, "live_keys": sum(live)}
    idx = torch.arange(n_keys, device="cuda")
    ql = q.to(kp.dtype)
    if name == "flash_decode":
        # one PyTorch call for the same function: SDPA with a boolean mask
        lo = max(0, pos - w + 1) if w > 0 else 0
        mask = ((idx <= pos) & (idx >= lo))[None, None, None]
        rec["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            ql, kc, vc, attn_mask=mask, enable_gqa=True))
    else:
        # no one call reads through a page table: the gather + SDPA pair
        # is a note beside B6, not its library time
        rec["library_ms"] = None
        n_pages, page_len = kp.shape[:2]
        lens_l = lens.long()[:, None]
        lo = (lens_l - w + 1).clamp_min(0) if w > 0 else torch.zeros_like(
            lens_l)
        mask = ((idx[None] <= lens_l) & (idx[None] >= lo))[:, None, None]
        gather = tbl.long().clamp(0, n_pages - 1)

        def gather_sdpa():
            k = kp[gather].reshape(rows, n_keys, kvh, hd).transpose(1, 2)
            v = vp[gather].reshape(rows, n_keys, kvh, hd).transpose(1, 2)
            return F.scaled_dot_product_attention(ql, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        rec["gather_sdpa_ms"] = cuda_ms(gather_sdpa)
    return rec


class _StubHooks:
    """Device-free scheduler hooks: the schedule the engine must follow."""

    def admit(self, slot, req, pages, **kw):
        pass

    def prefill(self, slot, req, chunk, pos, last):
        pass

    def decode(self, slots):
        pass

    def evict(self, slot, req):
        pass


def _timed_decode(engine, profile_ticks=None):
    """Wrap ``engine.decode`` to record each tick's host time (a tick ends
    in the sync that pulls its tokens) and, for the decode ticks whose
    index is in ``profile_ticks``, each one's device kernels under its own
    ``torch.profiler`` window (prefill calls between them stay outside).
    Returns the record dict the wrapper fills."""
    from torch.profiler import ProfilerActivity, profile
    inner = engine.decode
    rec = {"tick_s": [], "rows": [], "profiled": []}

    def decode(slots):
        i = len(rec["tick_s"])
        prof = None
        if profile_ticks and i in profile_ticks:
            # device activity only: recording every host op slows the
            # eager host loop several times over
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        out = inner(slots)
        wall = time.perf_counter() - t0
        rec["tick_s"].append(wall)
        rec["rows"].append(len(slots))
        if prof is not None:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            kern = {}
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    kern[ev.name] = kern.get(ev.name, 0.0) + \
                        ev.time_range.elapsed_us()
            rec["profiled"].append({"rows": len(slots), "wall_s": wall,
                                    "kernels_us": kern})
        return out
    engine.decode = decode
    return rec


def _profile_share(profiled, timed):
    """Device busy, B6 time and idle share of the profiled decode ticks;
    the unprofiled idle share holds their device time against the timed
    run's mean tick at the same row counts."""
    n = len(profiled)
    kern = {}
    for t in profiled:
        for name, us in t["kernels_us"].items():
            kern[name] = kern.get(name, 0.0) + us
    busy = sum(kern.values())
    b6 = sum(us for name, us in kern.items() if "paged_kernel" in name)
    wall_us = sum(t["wall_s"] for t in profiled) * 1e6
    mean_at = {}
    for s_, m in zip(timed["tick_s"], timed["rows"]):
        mean_at.setdefault(m, []).append(s_)
    plain_us = sum(1e6 * sum(mean_at[t["rows"]]) / len(mean_at[t["rows"]])
                   for t in profiled)
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:12]
    return {"ticks": n, "rows": [t["rows"] for t in profiled],
            "ms_per_tick": wall_us / 1e3 / n,
            "device_busy_ms_per_tick": busy / 1e3 / n,
            "b6_ms_per_tick": b6 / 1e3 / n,
            "b6_share_of_tick": b6 / plain_us,
            "b6_share_of_device": b6 / busy if busy else 0.0,
            "device_idle_share": 1.0 - busy / wall_us,
            "unprofiled_ms_per_tick": plain_us / 1e3 / n,
            "device_idle_share_unprofiled": 1.0 - busy / plain_us,
            "top_kernels": [{"name": k[:90], "ms_per_tick": us / 1e3 / n,
                             "share": us / busy} for k, us in top]}


def serve_run(S, cfg, params, reqs, *, backend="paged", record=False,
              profile_ticks=None):
    """One ``ServeEngine.serve`` on the card with the launch counts set to
    0 just before it; returns what the run shows."""
    engine = S.ServeEngine(cfg, params, spec=S.PageSpec(**SERVE_SPEC),
                           backend=backend, prefill_chunk=SERVE_CHUNK,
                           record_logits=record)
    ticks = _timed_decode(engine, profile_ticks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    S.FD.reset_counts()
    t0 = time.perf_counter()
    recs = engine.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"recs": recs, "wall_s": wall, "log": engine.log,
           "stats": dict(engine.stats),
           "compile_log": list(engine.compile_log),
           "launches": {k: {v: S.FD.launch_count(k, v) for v in vs}
                        for k, vs in S.FD.KERNEL_VARIANTS.items()},
           "b6": S.FD.launch_count("flash_decode_paged"),
           "plain": S.FD.plain_count(), "ticks": ticks,
           "peak": torch.cuda.max_memory_allocated()}
    # the timing wrapper and the engine refer to each other: collect the
    # cycle so that its KV pool is freed before the next run's peak
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serving_phase(S):
    """Phase 12: the paged ServeEngine at the full width of phi3-mini
    (all 32 layers, bf16 params and compute, f32 pages), B6 in every layer
    of every decode tick; then the contiguous backend on the same
    requests."""
    import numpy as np
    cfg = S.get_config(SERVE_ARCH)
    params = S.models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    n_params = sum(t.numel() for t in S.tree_leaves(params))
    reqs = S.synthetic_workload(0, SERVE_REQUESTS, vocab=cfg.vocab_size,
                                **SERVE_WORKLOAD)
    spec = S.PageSpec(**SERVE_SPEC)
    want_log = S.run_serve_loop(reqs, spec, _StubHooks(),
                                prefill_chunk=SERVE_CHUNK)
    n_layers = cfg.n_layers
    runs = {}
    # the recorded run comes first and warms the card up (cuBLAS handles
    # and heuristics); the timed run has nothing else in it, the profiled
    # one runs the first PROFILE_TICKS decode ticks with every slot busy
    # under torch.profiler
    full = [i for i, e in enumerate(x for x in want_log if x[0] == "decode")
            if len(e[2]) == spec.n_slots][:PROFILE_TICKS]
    for leg, kw in (("paged_recorded", {"record": True}),
                    ("paged", {}),
                    ("paged_profiled", {"profile_ticks": set(full)}),
                    ("contig", {"backend": "contig", "record": True})):
        r = serve_run(S, cfg, params, reqs, **kw)
        calls = r["stats"]["decode_calls"]
        if r["log"] != want_log:
            raise AssertionError(f"{leg}: the engine's schedule differs from "
                                 "run_serve_loop's with stub hooks")
        want_b6 = n_layers * calls if kw.get("backend", "paged") == "paged" \
            else 0
        if r["b6"] != want_b6 or r["plain"] or \
                r["launches"]["flash_decode"]["f32"] + \
                r["launches"]["flash_decode"]["bf16"]:
            raise AssertionError(f"{leg}: launches {r['launches']}, plain "
                                 f"runs {r['plain']}: expected {want_b6} "
                                 "flash_decode_paged launches "
                                 f"({n_layers} layers x {calls} decode "
                                 "calls) and nothing else")
        for rec, q in zip(r["recs"], sorted(reqs, key=lambda x: x.rid)):
            if len(rec.tokens) != q.max_new or not all(
                    0 <= t < cfg.vocab_size for t in rec.tokens):
                raise AssertionError(f"{leg} rid {rec.rid}: tokens "
                                     f"{rec.tokens} (max_new {q.max_new})")
            if kw.get("record") and not all(
                    np.isfinite(lg).all() for lg in rec.logits):
                raise AssertionError(f"{leg} rid {rec.rid}: non-finite "
                                     "logits")
        runs[leg] = r
    main = runs["paged"]
    recs = main["recs"]
    n_tok = sum(len(x.tokens) for x in recs)
    ticks = main["ticks"]
    prof = _profile_share(runs["paged_profiled"]["ticks"]["profiled"],
                          ticks)
    out = {"arch": SERVE_ARCH, "params": n_params,
           "pool_bytes": spec.pool_bytes(cfg), "requests": len(reqs),
           "generated_tokens": n_tok, "wall_s": main["wall_s"],
           "tok_per_s": n_tok / main["wall_s"],
           "mean_ttft_s": float(np.mean([x.ttft_s for x in recs])),
           "mean_tpot_s": float(np.mean([x.tpot_s for x in recs])),
           "decode_calls": main["stats"]["decode_calls"],
           "prefill_calls": main["stats"]["prefill_calls"],
           "ms_per_decode_tick": 1e3 * float(np.mean(ticks["tick_s"])),
           "ms_per_decode_tick_8_rows": 1e3 * float(np.mean(
               [t for t, m in zip(ticks["tick_s"], ticks["rows"])
                if m == SERVE_SPEC["n_slots"]] or [float("nan")])),
           "b6_launches": main["b6"], "profile": prof,
           "peak_bytes": main["peak"],
           "compile_log": [list(k) for k in main["compile_log"]]}
    agree = [a == b for ra, rc in zip(runs["paged_recorded"]["recs"],
                                      runs["contig"]["recs"])
             for a, b in zip(ra.tokens, rc.tokens)]
    repeat = [ra.tokens == rb.tokens for ra, rb in
              zip(recs, runs["paged_recorded"]["recs"])]
    out.update(contig_wall_s=runs["contig"]["wall_s"],
               contig_tok_per_s=n_tok / runs["contig"]["wall_s"],
               paged_contig_token_agreement=sum(agree) / len(agree),
               paged_repeats_itself=all(repeat))
    log(f"serving main path: {SERVE_ARCH} full width ({n_params / 1e9:.2f} B "
        f"params, bf16), {len(reqs)} requests, {n_tok} tokens in "
        f"{out['wall_s']:.2f} s: {out['tok_per_s']:.1f} tok/s, mean TTFT "
        f"{out['mean_ttft_s'] * 1e3:.1f} ms, mean TPOT "
        f"{out['mean_tpot_s'] * 1e3:.2f} ms; {out['decode_calls']} decode "
        f"ticks ({out['ms_per_decode_tick']:.2f} ms each, "
        f"{out['ms_per_decode_tick_8_rows']:.2f} ms at 8 rows), "
        f"{out['prefill_calls']} prefill calls; {main['b6']} B6 launches "
        f"= {n_layers} x {out['decode_calls']}; peak "
        f"{main['peak'] / 2**30:.2f} GiB")
    log(f"  profiled decode ticks {full} (rows {prof['rows']}): "
        f"{prof['ms_per_tick']:.2f} ms/tick under the "
        f"profiler, {prof['unprofiled_ms_per_tick']:.2f} ms in the timed run; "
        f"device busy {prof['device_busy_ms_per_tick']:.2f} ms/tick (idle "
        f"{prof['device_idle_share_unprofiled']:.0%} of the timed tick), B6 "
        f"{prof['b6_ms_per_tick']:.3f} ms/tick "
        f"({prof['b6_share_of_tick']:.1%} of the tick, "
        f"{prof['b6_share_of_device']:.1%} of device time)")
    for k in prof["top_kernels"]:
        log(f"    {k['ms_per_tick']:7.3f} ms/tick {k['share']:6.1%}  "
            f"{k['name']}")
    log(f"  contiguous backend (plain attention) on the same requests: "
        f"{out['contig_tok_per_s']:.1f} tok/s; tokens agreeing with the "
        f"paged run {out['paged_contig_token_agreement']:.1%}; paged run "
        f"repeats itself: {out['paged_repeats_itself']}")
    path = {k: dict(v) for k, v in main["launches"].items()}
    del runs, params, main
    torch.cuda.empty_cache()
    return out, path


def serve_parity_phase(S):
    """Phase 13: the reduced gemma3-4b (uniform window 16) and phi3-mini
    in f32 on the card against the CPU port, on the churn workload:
    greedy tokens identical, logits within SERVE_PARITY_BAND; then on the
    card spec_k=3 and prefix sharing token-identical to one-token
    decode."""
    import numpy as np
    out = {}
    spec = S.PageSpec(page_len=16, pages_per_slot=4, n_slots=2)
    threads = torch.get_num_threads()
    for arch in ("gemma3-4b", "phi3-mini-3.8b"):
        cfg = S.reduced(S.get_config(arch))
        p_cpu = S.models.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
        p_card = S.tree_map(lambda t: t.cuda(), p_cpu)
        reqs = S.synthetic_workload(1, 8, vocab=cfg.vocab_size,
                                    prompt_lens=(3, 20), gen_short=(3, 8),
                                    gen_long=(12, 20), p_long=0.3)
        torch.backends.cuda.matmul.allow_tf32 = True    # the engine turns
        S.FD.reset_counts()                             # it off itself
        card = S.ServeEngine(cfg, p_card, spec=spec, prefill_chunk=8,
                             record_logits=True)
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("the serving engine left TF32 on")
        rc = card.serve(reqs)
        b6 = S.FD.launch_count("flash_decode_paged")
        if b6 != cfg.n_layers * card.stats["decode_calls"] or \
                S.FD.plain_count():
            raise AssertionError(f"{arch} reduced: {b6} B6 launches for "
                                 f"{card.stats['decode_calls']} decode calls")
        torch.set_num_threads(1)
        try:
            cpu = S.ServeEngine(cfg, p_cpu, spec=spec, prefill_chunk=8,
                                record_logits=True, device="cpu")
            rp = cpu.serve(reqs)
        finally:
            torch.set_num_threads(threads)
        same = all(a.tokens == b.tokens for a, b in zip(rc, rp))
        gap = max(float(np.abs(x - y).max()) for a, b in zip(rc, rp)
                  for x, y in zip(a.logits, b.logits))
        margin = min(float(np.diff(np.sort(y)[-2:])[0]) for b in rp
                     for y in b.logits)
        log(f"serve parity {arch} reduced (f32, window "
            f"{cfg.attn_window}), card vs CPU: tokens identical {same}, "
            f"logit gap {gap:.3g} (band {SERVE_PARITY_BAND:g}), smallest "
            f"top-2 margin {margin:.3g}; {b6} B6 launches")
        if not same or gap > SERVE_PARITY_BAND or card.log != cpu.log:
            raise AssertionError(f"{arch} reduced: the card and the CPU "
                                 "port disagree")
        # speculative decode and prefix sharing on the card
        sspec = S.PageSpec(page_len=8, pages_per_slot=10, n_slots=2)
        rep = S.repetitive_workload(3, 6, vocab=cfg.vocab_size, prompt_len=12,
                                    gen=(8, 14))
        toks = lambda recs: {r.rid: tuple(r.tokens) for r in recs}
        base = S.ServeEngine(cfg, p_card, spec=sspec, prefill_chunk=8,
                             record_logits=True)
        t0 = toks(base.serve(rep))
        fast = S.ServeEngine(cfg, p_card, spec=sspec, prefill_chunk=8,
                             spec_k=3)
        t1 = toks(fast.serve(rep))
        pspec = S.PageSpec(page_len=8, pages_per_slot=10, n_slots=4)
        shared = S.shared_prefix_workload(1, 6, vocab=cfg.vocab_size,
                                          prefix_len=24, suffix_len=6,
                                          gen=(10, 14), p_dup=0.5,
                                          arrival_gap=2)
        plain = S.ServeEngine(cfg, p_card, spec=pspec, prefill_chunk=8)
        share = S.ServeEngine(cfg, p_card, spec=pspec, prefill_chunk=8,
                              prefix_share=True)
        t2, t3 = toks(plain.serve(shared)), toks(share.serve(shared))
        base_margin = min(float(np.diff(np.sort(y)[-2:])[0])
                          for r in base.records.values() for y in r.logits)
        log(f"  on the card: spec_k=3 identical to one-token decode "
            f"{t0 == t1} (accept rate {fast.accept_rate:.3f}, "
            f"{fast.stats['spec_dispatches']} verify ticks; smallest top-2 "
            f"margin of the one-token run {base_margin:.3g}); prefix "
            f"sharing identical {t2 == t3} (skipped "
            f"{share.prefill_skip_frac:.1%} of prompt tokens, "
            f"{share.stats['cow_copies']} COW copies)")
        if t0 != t1 or t2 != t3 or fast.stats["spec_dispatches"] == 0 or \
                share.stats["cow_copies"] == 0:
            raise AssertionError(f"{arch} reduced on the card: speculative "
                                 "decode or prefix sharing changed the "
                                 "tokens")
        out[arch] = {"tokens_identical": same, "logit_gap": gap,
                     "min_margin": margin, "b6_launches": b6,
                     "spec_accept_rate": fast.accept_rate,
                     "spec_margin": base_margin,
                     "prefix_skip_frac": share.prefill_skip_frac}
    return out


# ------------------------------ phases 14-17: prefill -------------------------
PF_REFERENCE = {"flash_attention": ("src/repro/kernels/flash_attention.py", 83),
                "mamba_ssd_scan": ("src/repro/kernels/mamba_scan.py", 63),
                "wkv6_chunked": ("src/repro/kernels/wkv6.py", 46)}
PF_CSRC = {"flash_attention": "src/repro_torch/csrc/flash_attention.cu",
           "mamba_ssd_scan": "src/repro_torch/csrc/mamba_scan.cu",
           "wkv6_chunked": "src/repro_torch/csrc/wkv6.cu"}
BF16_RATE = 989e12               # dense bf16 tensor-core rate (data sheet)
# the labels of the model geometries, at which the kernels are timed
PF_MODELS = ("zamba2-2.7b", "phi3-mini-3.8b", "gemma3-4b", "rwkv6-7b")
# B4: (label, B, H, KV, Sq, Sk, hd, causal, windows) — the model geometries
# at the prefill main path's 2 x 2048 tokens (zamba2-2.7b's shared
# attention, phi3-mini-3.8b, gemma3-4b's local and global layers), then
# the shapes of the CPU tests: a ragged S with hd 64 and 80, the sweep of
# the reference's tests, and non-causal (cross-attention) ones; then the
# edges of the tensor-core form: hd 96 and 256 with GQA at a ragged S and a
# window (100) that is no multiple of a key tile
FA_SHAPES = (("zamba2-2.7b", 2, 32, 32, 2048, 2048, 80, True, (0,)),
             ("phi3-mini-3.8b", 2, 32, 32, 2048, 2048, 96, True, (0,)),
             ("gemma3-4b", 2, 8, 4, 2048, 2048, 256, True, (1024, 0)),
             ("reduced-ragged", 2, 4, 2, 45, 45, 64, True, (16, 0)),
             ("hd80-ragged", 1, 4, 2, 100, 100, 80, True, (0, 32)),
             ("sweep-gqa8", 2, 8, 1, 256, 256, 128, True, (0, 64)),
             ("sweep-hd32", 1, 4, 4, 128, 128, 32, True, (0,)),
             ("noncausal", 1, 2, 2, 128, 128, 64, False, (0,)),
             ("cross", 2, 4, 2, 50, 77, 64, False, (0,)),
             ("hd96-gqa-ragged", 1, 8, 2, 200, 200, 96, True, (0, 100)),
             ("hd256-gqa-ragged", 1, 8, 2, 200, 200, 256, True, (0, 100)))
# B7: (label, Bt, H, S, P, N) — zamba2-2.7b's SSD at 2 x 2048 tokens (80
# heads of 64, state 64, chunk 256) on contiguous tensors and on the views
# ``mamba2_block`` passes (SSD_VIEWS), the reduced zamba2 of the CPU tests
# at a ragged S, and the reference's sweep
SSD_VIEWS = "zamba2-2.7b views"
SSD_SHAPES = (("zamba2-2.7b", 2, 80, 2048, 64, 64),
              (SSD_VIEWS, 2, 80, 2048, 64, 64),
              ("reduced-ragged", 2, 16, 45, 32, 16),
              ("sweep-1", 2, 3, 256, 64, 16), ("sweep-2", 1, 2, 128, 32, 64),
              ("sweep-3", 2, 1, 192, 64, 32), ("sweep-4", 1, 4, 64, 128, 8))
# B8: (label, B, H, S, K, V) — rwkv6-7b's WKV at 2 x 2048 tokens on
# contiguous tensors and in the model's form (WKV_VIEWS: the views
# ``time_mix`` passes, f32 output), strong decays (WKV_STRONG, the model's
# form, w = exp(−exp(U(−3, ln 46))) down to 1e-20), the reduced rwkv6 at
# a ragged S, and the reference's sweep
WKV_VIEWS = "rwkv6-7b views"
WKV_STRONG = "strong-decay views"
WKV_SHAPES = (("rwkv6-7b", 2, 64, 2048, 64, 64),
              (WKV_VIEWS, 2, 64, 2048, 64, 64),
              (WKV_STRONG, 2, 8, 300, 64, 64),
              ("reduced-ragged", 2, 4, 45, 64, 64),
              ("sweep-1", 2, 2, 128, 32, 32), ("sweep-2", 1, 3, 96, 64, 64),
              ("sweep-3", 1, 1, 64, 128, 64))
# kernel against plain, elementwise.  f32: |kernel - plain| <= tol·(1 +
# |plain|) with tol 2e-5, x5 for the SSD scan (the reference's own tests'
# atol = rtol): the two sum in other orders, with fused multiply-adds in
# the kernels.  bf16: both compute in f32 from the same bf16 inputs and
# round once at the store, so the f32 results lie within that tolerance
# and each rounding moves a value by at most half a bf16 ulp: the f32
# tolerance plus one bf16 ulp of the larger of |kernel| and |plain|.
PF_F32_TOL = 2e-5
PF_TOL_SCALE = {"flash_attention": 1.0, "mamba_ssd_scan": 5.0,
                "wkv6_chunked": 1.0}
# the prefill main path: 2 prompts of 2048 random tokens, bf16, full width
PREFILL_ARCHS = ("zamba2-2.7b", "rwkv6-7b")
PREFILL_BATCH, PREFILL_SEQ = 2, 2048
PREFILL_TIMED = 3
# card vs CPU port on the reduced configs in f32 at a ragged S (45 tokens;
# zamba2 at 6 layers so that its shared block runs), last-position logits
# of magnitude about 4: the kernels sum in other orders than the CPU's
# scans (B7 step by step where the CPU runs the chunked form)
PREFILL_PARITY_ARCHS = (("zamba2-2.7b", 6), ("rwkv6-7b", 2),
                        ("gemma3-4b", 2), ("phi3-mini-3.8b", 2))
PREFILL_PARITY_SEQ = 45
PREFILL_PARITY_BAND = 1e-4


def _pf_err(kernel, out, ref):
    """(max abs diff, worst |diff| / limit): the limit tol·(1 + |plain|),
    plus one bf16 ulp of the larger magnitude for bf16 outputs."""
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    limit = PF_F32_TOL * PF_TOL_SCALE[kernel] * (1.0 + r.abs())
    if out.dtype == torch.bfloat16:
        limit = limit + bf16_ulp(torch.maximum(o.abs(), r.abs()))
    return float(diff.max()), float((diff / limit).max())


def _fa_inputs(shape, dtype, seed):
    _, b, h, kvh, sq, sk, hd, _, _ = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    return mk(b, h, sq, hd), mk(b, kvh, sk, hd), mk(b, kvh, sk, hd)


def _ssd_inputs(shape, dtype, seed):
    """The reference's test distribution: dt = |N| 0.1 + 0.01, A_log =
    log(linspace(1, 8)), B and C = 0.3 N, D = 1.  For SSD_VIEWS, the views
    ``mamba2_block`` passes: x, B and C the columns of one (Bt, S, H·P +
    2N) conv output (x as its (Bt, H, S, P) transpose), dt the (Bt, H, S)
    transpose of a (Bt, S, H) tensor."""
    label, bt, h, s, p, n = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    a_log = torch.log(torch.linspace(1.0, 8.0, h, device="cuda"))
    if label == SSD_VIEWS:
        conv = torch.cat([rn(bt, s, h * p), rn(bt, s, 2 * n) * 0.3],
                         dim=-1).to(dtype)
        x = conv[..., :h * p].view(bt, s, h, p).transpose(1, 2)
        dt = (rn(bt, s, h).abs() * 0.1 + 0.01).transpose(1, 2)
        B, C = conv[..., h * p:h * p + n], conv[..., h * p + n:]
        return x, dt, a_log, B, C, torch.ones(h, device="cuda")
    x = rn(bt, h, s, p).to(dtype)
    dt = rn(bt, h, s).abs() * 0.1 + 0.01
    B = (rn(bt, s, n) * 0.3).to(dtype)
    C = (rn(bt, s, n) * 0.3).to(dtype)
    return x, dt, a_log, B, C, torch.ones(h, device="cuda")


def _wkv_inputs(shape, dtype, seed):
    """The reference's test distribution: r, k, v = 0.5 N in ``dtype``, w
    = sigmoid(N)/2 + 1/2 in f32 (the card's kernel reads the decay in f32,
    as the model makes it), u = 0.3 N.  For WKV_VIEWS and WKV_STRONG, the
    views ``time_mix`` passes: (B, H, S, ·) transposes of (B, S, H, ·)
    tensors; WKV_STRONG's w = exp(−exp(U(−3, ln 46)))."""
    label, b, h, s, kd, vd = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    if label in (WKV_VIEWS, WKV_STRONG):
        t = lambda x: x.transpose(1, 2)
        r, k = (t((rn(b, s, h, kd) * 0.5).to(dtype)) for _ in range(2))
        v = t((rn(b, s, h, vd) * 0.5).to(dtype))
        if label == WKV_STRONG:
            x = torch.rand(b, s, h, kd, generator=gen, device="cuda")
            w = t(torch.exp(-torch.exp(-3.0 + x * (math.log(46.0) + 3.0))))
        else:
            w = t(torch.sigmoid(rn(b, s, h, kd)) * 0.5 + 0.5)
        return r, k, v, w, rn(h, kd) * 0.3
    r, k = (rn(b, h, s, kd) * 0.5).to(dtype), (rn(b, h, s, kd) * 0.5).to(dtype)
    v = (rn(b, h, s, vd) * 0.5).to(dtype)
    w = torch.sigmoid(rn(b, h, s, kd)) * 0.5 + 0.5
    return r, k, v, w, rn(h, kd) * 0.3


def _band_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a row-wise mask keeps: the work of B4."""
    if not causal:
        return sq * sk
    return sum(min(i + 1, sk, window) if window > 0 else min(i + 1, sk)
               for i in range(sq))


def _ssd_chunked_flops(bt, h, s, p, n, q=64):
    """The products of B7's bf16 form: per (b, h) and chunk of q steps,
    C·Bᵀ (q x q x N), the masked decay matrix's two bf16 parts times x (q x
    q x P), C times the state's two parts (q x N x P, from the second chunk
    on) and xᵀ times W's two parts (P x q x N), 2 operations a
    multiply-add; a ragged last chunk runs whole."""
    nc = -(-s // q)
    per_chunk = 2 * q * q * n + 2 * (2 * q * q * p) + 2 * (2 * p * q * n)
    return bt * h * (nc * per_chunk + (nc - 1) * 2 * (2 * q * n * p))


def _wkv_chunked_flops(b, h, s, kd, vd, q=64, sub=16, parts=3):
    """The products of B8's tensor-core form: per (b, h) and chunk of q
    steps, with K padded to 64 and each f32 operand in ``parts`` bf16
    parts (6 products of two split sides, 3 against an exact one): y_inter
    (q x K x V, from the second chunk on), the 3 off-diagonal block
    columns of A (q x K x 16 each), A·v (q x q x V) and the state update
    (K x q x V), 2 operations a multiply-add; a ragged last chunk runs
    whole."""
    kp, nc = 64, -(-s // q)
    two, one = parts * (parts + 1) // 2, parts
    per_chunk = (2 * (q // sub - 1) * two * q * kp * sub
                 + 2 * one * q * q * vd + 2 * one * kp * q * vd)
    return b * h * (nc * per_chunk + (nc - 1) * 2 * two * q * kp * vd)


def _pf_bound(kernel, args, rate, window=0, causal=True, out_dtype=None):
    """(bound ms, bound_by, flops, bytes, op rate): each input read once,
    each output written once; the operations the kernel's algorithm does
    on these inputs (B4: the causal / window band only) at the rate of the
    units it runs on — the bf16 forms of B4 and B7 the dense bf16
    tensor-core rate (B7's chunked products, splits included), the rest
    the f32 rate of the CUDA cores (B7's f32 form the step recurrence)."""
    op_rate = F32_RATE
    if kernel == "flash_attention":
        q, k, v = args
        b, h, sq, hd = q.shape
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * hd * b * h * _band_pairs(sq, k.shape[2], causal, window)
        if q.dtype == torch.bfloat16:
            op_rate = BF16_RATE
    elif kernel == "mamba_ssd_scan":
        x, dt, a_log, B, C, D = args
        bt, h, s, p = x.shape
        n = B.shape[-1]
        nbytes = (2 * x.numel() + B.numel() + C.numel()) * x.element_size() \
            + 4 * (dt.numel() + 2 * h)
        if x.dtype == torch.bfloat16:
            flops = _ssd_chunked_flops(bt, h, s, p, n)
            op_rate = BF16_RATE
        else:
            flops = 5 * p * n * s * bt * h    # decay, update, y = h·C
    else:
        r, k, v, w, u = args
        b, h, s, kd = r.shape
        y_size = (out_dtype or r.dtype).itemsize
        nbytes = (2 * r.numel() + v.numel()) * r.element_size() \
            + w.numel() * w.element_size() + v.numel() * y_size \
            + 4 * u.numel()
        if r.dtype == torch.bfloat16 and kd <= 64:
            flops = _wkv_chunked_flops(b, h, s, kd, v.shape[-1])
            op_rate = BF16_RATE
        else:
            flops = 7 * kd * v.shape[-1] * s * b * h
    t_bytes, t_ops = nbytes / rate, flops / op_rate
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes,
            op_rate)


def _pf_cases():
    for shape in FA_SHAPES:
        for w in shape[-1]:
            yield "flash_attention", shape, w
    for shape in SSD_SHAPES:
        yield "mamba_ssd_scan", shape, None
    for shape in WKV_SHAPES:
        yield "wkv6_chunked", shape, None


def pf_kernel_phase(P, rate):
    """Phase 14: B4, B7 and B8 against their plain versions at every shape
    of FA_SHAPES / SSD_SHAPES / WKV_SHAPES in f32 and bf16, and timed at
    the model geometries (the first shape of each table; B4 at every model
    geometry) beside the plain version, the library call and the bound.
    Returns per-kernel lists of records."""
    out = {k: [] for k in PF_REFERENCE}
    plain_fns = {"flash_attention": P.FA.flash_attention_plain,
                 "mamba_ssd_scan": P.SSD.mamba_ssd_plain,
                 "wkv6_chunked": P.WKV.wkv6_plain}
    kern_fns = {"flash_attention": P.FA.flash_attention,
                "mamba_ssd_scan": P.SSD.mamba_ssd_scan,
                "wkv6_chunked": P.WKV.wkv6_chunked}
    make = {"flash_attention": _fa_inputs, "mamba_ssd_scan": _ssd_inputs,
            "wkv6_chunked": _wkv_inputs}
    for ci, (kernel, shape, w) in enumerate(_pf_cases()):
        label = shape[0]
        model = label.split()[0] in PF_MODELS
        kw = {}
        if kernel == "flash_attention":
            kw = {"causal": shape[7], "window": w}
        if label in (WKV_VIEWS, WKV_STRONG):
            kw = {"out_dtype": torch.float32}         # as time_mix asks
        for dtype in (torch.float32, torch.bfloat16):
            args = make[kernel](shape, dtype, seed=1000 + ci)
            got = kern_fns[kernel](*args, **kw)
            want = plain_fns[kernel](*args, **kw)
            torch.cuda.synchronize()
            err, ratio = _pf_err(kernel, got, want)
            if not ratio <= 1.0 or not torch.isfinite(got).all():
                raise AssertionError(
                    f"{kernel} {label} {dtype} {kw}: kernel differs from its "
                    f"plain version by {err} ({ratio:.3g} x the tolerance)")
            rec = {"shape": label, "dtype": str(dtype)[6:], "max_abs_err": err,
                   "err_over_tol": ratio,
                   **{k: str(v)[6:] if isinstance(v, torch.dtype) else v
                      for k, v in kw.items()}}
            if model:
                bound_ms, bound_by, flops, nbytes, op_rate = _pf_bound(
                    kernel, args, rate, **kw)
                slow = kernel != "flash_attention"   # per-step plain versions
                rec.update(
                    ms=cuda_ms(lambda: kern_fns[kernel](*args, **kw)),
                    plain_ms=cuda_ms(lambda: plain_fns[kernel](*args, **kw),
                                     per_group=1 if slow else 3,
                                     groups=3, warmup=1),
                    bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                    bytes=nbytes, op_rate=op_rate,
                    bf16_tensor_core_ms=1e3 * flops / BF16_RATE,
                    library_ms=None)
                if kernel == "flash_attention":
                    q, k, v = args
                    if w > 0:
                        i = torch.arange(q.shape[2], device="cuda")
                        d = i[:, None] - i[None, :]
                        mask = (d >= 0) & (d < w)
                        lib = lambda: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=mask, enable_gqa=True)
                    else:
                        lib = lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True, enable_gqa=True)
                    rec["library_ms"] = cuda_ms(lib)
                    rec["vs_library"] = rec["ms"] / rec["library_ms"]
                by = bound_by if bound_by == "bytes" else (
                    "bf16 tensor-core" if op_rate == BF16_RATE
                    else "f32") + " operations"
                log(f"    {kernel} {label} {rec['dtype']} {kw or ''}: kernel "
                    f"{rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, "
                    "library " + ("-" if rec["library_ms"] is None
                                  else f"{rec['library_ms']:.3f} ms (kernel "
                                  f"{rec['vs_library']:.2f} x)")
                    + f", bound {bound_ms:.3f} ms by {by} "
                    f"({bound_ms / rec['ms']:.1%} of it; bf16 tensor cores "
                    f"{rec['bf16_tensor_core_ms']:.3f} ms), err {err:.3g}")
            out[kernel].append(rec)
            del args, got, want
        torch.cuda.empty_cache()
    for kernel, recs in out.items():
        log(f"  {kernel}: {len(recs)} cases within tolerance of the plain "
            f"version (worst {max(r['err_over_tol'] for r in recs):.3g} x "
            "the tolerance)")
    return out


# the kernel names of B4, B7 and B8 in a profile
PF_KERNEL_NAMES = {"flash_attention": ("attention_kernel",
                                       "attention_wgmma_kernel"),
                   "mamba_ssd_scan": ("ssd_kernel", "ssd_wgmma_kernel"),
                   "wkv6_chunked": ("wkv6_kernel", "wkv_wgmma_kernel")}


def _prefill_profile(prefill, params, tokens, launches):
    """One prefill under torch.profiler (device activity): device busy ms,
    the top kernels and the share of B4, B7 and B8."""
    kern, count, wall = traced_kernels(
        lambda: prefill(params, tokens),
        sum(PF_KERNEL_NAMES.values(), ()), sum(launches.values()))
    n_copy = sum(c for n, c in count.items() if "copy" in n)
    busy = sum(kern.values())
    share = lambda *keys: sum(us for n, us in kern.items()
                              if any(k in n for k in keys)) / busy \
        if busy else 0.0
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (wall * 1e6),
            "b4_share": share(*PF_KERNEL_NAMES["flash_attention"]),
            "b7_share": share(*PF_KERNEL_NAMES["mamba_ssd_scan"]),
            "b8_share": share(*PF_KERNEL_NAMES["wkv6_chunked"]),
            "copy_launches": n_copy,
            "copy_ms": share("copy") * busy / 1e3, "copy_share": share("copy"),
            "top_kernels": [{"name": n[:90], "ms": us / 1e3,
                             "share": us / busy} for n, us in top]}


def prefill_phase(P):
    """Phase 15: ``make_prefill_step`` at full width in bf16 on 2 x 2048
    random tokens: zamba2-2.7b (45 B7 and 9 B4 launches a forward) and
    rwkv6-7b (32 B8), no plain runs, finite last-position logits; ms per
    prefill, tokens/s, a profile of one prefill and peak memory.  Returns
    (records, launches per kernel of one forward)."""
    import numpy as np
    out, launches = {}, {k: 0 for k in PF_REFERENCE}
    for arch in PREFILL_ARCHS:
        cfg = P.get_config(arch)
        segs = P.layout(cfg)
        want = {"flash_attention": sum(s.count for s in segs
                                       if s.kind in ("attn", "shared_attn")),
                "mamba_ssd_scan": sum(s.count for s in segs
                                      if s.kind == "mamba2"),
                "wkv6_chunked": sum(s.count for s in segs
                                    if s.kind == "rwkv6")}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = P.models.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in P.tree_leaves(params))
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in P.tree_leaves(params))
        tokens = torch.from_numpy(np.random.default_rng(7).integers(
            0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ))).cuda()
        prefill = P.make_prefill_step(cfg)
        prefill(params, tokens)                      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        P.reset_counts()
        logits = prefill(params, tokens)
        torch.cuda.synchronize()
        got = P.counts()
        peak = torch.cuda.max_memory_allocated()
        if got["launches"] != want or got["plain"]:
            raise AssertionError(f"{arch} prefill: launches "
                                 f"{got['launches']}, plain runs "
                                 f"{got['plain']}; expected {want} and none")
        if tuple(logits.shape) != (PREFILL_BATCH, cfg.vocab_size) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"{arch} prefill: logits "
                                 f"{tuple(logits.shape)} finite "
                                 f"{bool(torch.isfinite(logits).all())}")
        for k, n in got["launches"].items():
            launches[k] += n
        times = []
        for _ in range(PREFILL_TIMED):
            t0 = time.perf_counter()
            prefill(params, tokens)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = 1e3 * statistics.median(times)
        prof = _prefill_profile(prefill, params, tokens, got["launches"])
        n_tok = PREFILL_BATCH * PREFILL_SEQ
        out[arch] = {"params": n_params, "weight_bytes": weight_bytes,
                     "init_s": init_s, "tokens": n_tok,
                     "ms_per_prefill": ms,
                     "ms_per_prefill_runs": [1e3 * t for t in times],
                     "tokens_per_s": n_tok / (ms / 1e3),
                     "launches": got["launches"], "peak_bytes": peak,
                     "profile": prof}
        log(f"prefill main path: {arch} full width ({n_params / 1e9:.2f} B "
            f"params, {weight_bytes / 1e9:.2f} GB bf16), {PREFILL_BATCH} x "
            f"{PREFILL_SEQ} tokens: {ms:.1f} ms per prefill (runs "
            f"{[round(1e3 * t, 1) for t in times]}), "
            f"{out[arch]['tokens_per_s']:.0f} tokens/s; launches "
            f"{got['launches']}; peak {peak / 2**30:.2f} GiB")
        log(f"  profiled prefill: {prof['wall_ms']:.1f} ms, device busy "
            f"{prof['device_busy_ms']:.1f} ms (idle "
            f"{prof['device_idle_share']:.1%}); B4 {prof['b4_share']:.1%}, "
            f"B7 {prof['b7_share']:.1%}, B8 {prof['b8_share']:.1%} of "
            "device time")
        log(f"  copy kernels (names with 'copy': casts, transposes made "
            f"contiguous): {prof['copy_launches']} launches, "
            f"{prof['copy_ms']:.2f} ms ({prof['copy_share']:.1%} of device "
            "time)")
        for k in prof["top_kernels"]:
            log(f"    {k['ms']:8.3f} ms {k['share']:6.1%}  {k['name']}")
        if got["launches"]["flash_attention"] and not prof["b4_share"] > 0:
            raise AssertionError(f"{arch} prefill launched B4 but the "
                                 "profile finds no time under its names")
        del params, logits, prefill
        gc.collect()
        torch.cuda.empty_cache()
    return out, launches


def prefill_parity_phase(P):
    """Phase 16: reduced f32 models on the card (B4 / B7 / B8) against the
    CPU port (the XLA-scan ports) on the same params and tokens, within
    PREFILL_PARITY_BAND."""
    import numpy as np
    out = {}
    threads = torch.get_num_threads()
    for arch, layers in PREFILL_PARITY_ARCHS:
        cfg = P.reduced(P.get_config(arch), layers=layers)
        p_cpu = P.models.init_params(cfg, torch.Generator().manual_seed(3),
                                     device="cpu")
        p_card = P.tree_map(lambda t: t.cuda(), p_cpu)
        tok = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, (2, PREFILL_PARITY_SEQ)))
        prefill = P.make_prefill_step(cfg)
        torch.backends.cuda.matmul.allow_tf32 = True     # the step turns
        P.reset_counts()                                 # it off itself
        card = prefill(p_card, tok.cuda()).cpu()
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("the prefill step left TF32 on")
        got = P.counts()
        torch.set_num_threads(1)
        try:
            cpu = prefill(p_cpu, tok)
        finally:
            torch.set_num_threads(threads)
        gap = float((card - cpu).abs().max())
        out[arch] = {"layers": layers, "logit_gap": gap,
                     "logit_max": float(cpu.abs().max()),
                     "launches": got["launches"]}
        log(f"prefill parity {arch} reduced ({layers} layers, f32, S "
            f"{PREFILL_PARITY_SEQ}), card vs CPU: logit gap {gap:.3g} (band "
            f"{PREFILL_PARITY_BAND:g}, logits up to "
            f"{out[arch]['logit_max']:.2f}); launches {got['launches']}")
        if not gap <= PREFILL_PARITY_BAND or got["plain"] or \
                not sum(got["launches"].values()):
            raise AssertionError(f"{arch} reduced: the card and the CPU port "
                                 "disagree, or the card ran no kernel")
    return out


def ops_phase(P):
    """Phase 17: each front end of ``kernels/ops.py`` once on the card,
    one launch of its kernel, held against the plain version."""
    from repro_torch.kernels import dbl_merge as K
    from repro_torch.kernels import flash_decode as FD
    ops = P.ops
    out = {}
    fa = _fa_inputs(FA_SHAPES[3], torch.float32, 1)
    ssd = _ssd_inputs(SSD_SHAPES[1], torch.float32, 2)
    wkv = _wkv_inputs(WKV_SHAPES[3], torch.float32, 3)   # reduced-ragged
    gen = torch.Generator(device="cuda").manual_seed(4)
    qd = torch.randn(2, 4, 1, 64, generator=gen, device="cuda")
    kc = torch.randn(2, 2, 64, 64, generator=gen, device="cuda")
    vc = torch.randn(2, 2, 64, 64, generator=gen, device="cuda")
    tree = {"a": torch.randn(3, 5, generator=gen, device="cuda"),
            "b": torch.randn(7, generator=gen, device="cuda")}
    gl = P.tree_map(lambda t: torch.randn_like(t), tree)
    gs = P.tree_map(lambda t: torch.randn_like(t), tree)
    cases = (
        ("flash_attention", P.FA, "flash_attention",
         lambda: ops.flash_attention(*fa, window=16),
         lambda: P.FA.flash_attention_plain(*fa, window=16), 2e-5),
        ("flash_decode", FD, "flash_decode",
         lambda: ops.flash_decode(qd, kc, vc, 40, window=8),
         lambda: FD._xla_decode(qd, kc, vc, 40, window=8), 2e-5),
        ("mamba_ssd", P.SSD, "mamba_ssd_scan",
         lambda: ops.mamba_ssd(*ssd, chunk=32),
         lambda: P.SSD.mamba_ssd_plain(*ssd), 1e-4),
        ("wkv6", P.WKV, "wkv6_chunked", lambda: ops.wkv6(*wkv),
         lambda: P.WKV.wkv6_plain(*wkv), 2e-5),
        ("dbl_merge", K, "dbl_merge_flat2d",
         lambda: ops.dbl_merge(tree, gl, gs, factor=0.81, lr=0.05),
         lambda: P.tree_map(lambda p, a, b: P.dbl_merge_ref(
             p, a, b, factor=0.81, lr=0.05), tree, gl, gs), 1e-6))
    for front, mod, kernel, call, plain, tol in cases:
        mod.reset_counts()
        got = call()
        n = mod.launch_count(kernel)
        want = plain()
        torch.cuda.synchronize()
        gap = max(float((a.float() - b.float()).abs().max()) for a, b in
                  zip(P.tree_leaves(got), P.tree_leaves(want)))
        out[front] = {"kernel": kernel, "launches": n, "max_abs_err": gap}
        log(f"  ops.{front}: {n} {kernel} launch, {gap:.3g} from the plain "
            f"version (tolerance {tol:g})")
        if n != 1 or mod.plain_count() or not gap <= tol:
            raise AssertionError(f"ops.{front}: {n} launches of {kernel}, "
                                 f"{gap} from the plain version")
    return out


# ------------------------- phases 18-19: LM training ------------------------
# the LM training main path: full-width phi3-mini-3.8b through the training
# CLI's entry point, hybrid dual-batch x CPL (seq 64 -> 128), fused SGD
LM_ARCH = "phi3-mini-3.8b"
LM_ARGV = ["--arch", LM_ARCH, "--full", "--optimizer", "sgd", "--scheme",
           "hybrid", "--seq", "128", "--global-batch", "16", "--lr", "5e-3",
           "--steps", "40"]
LM_STEPS, LM_SEQS = 40, (64, 128)
# rows of the flat store a slice of B1's plain version covers (the plain
# version's two store-sized temporaries would not fit beside the buffers)
PLAIN_SLICE_ROWS = 1 << 20
# card vs CPU port: reduced f32 LMs, a few dual-batch steps of each form
TRAIN_PARITY_ARCHS = (("phi3-mini-3.8b", 2), ("gemma3-4b", 2),
                      ("zamba2-2.7b", 6), ("rwkv6-7b", 2))
TRAIN_PARITY_ARGS = dict(scheme="dbl", seq=32, global_batch=16, steps=4,
                         lr=5e-3, k=1.05, n_small=3, micro_steps=0, seed=0)
# losses are the history's, rounded to 4 decimals (one unit may separate
# equal runs); params max abs after 4 SGD steps (the CPU port lies within
# 1e-6 of the JAX package's on the same steps, tests/test_torch_lm_train.py).
# AdamW amplifies rounding: a step moves a weight whose gradient lies near 0
# by up to lr on a rounding difference, and later steps carry it on.  So its
# losses, params and moments (relative to each leaf's largest value) are
# held to "sensitivity" times the gap between two CPU runs whose initial
# params differ by 2e-7 relative noise (about 2 ulp): the run's own
# sensitivity to rounding, measured in this run (losses at least to the
# loss band).
TRAIN_PARITY_BAND = {"loss": 1.5e-4, "params": 1e-5, "sensitivity": 4.0}
SENSITIVITY_NOISE = 2e-7
# resume: reduced phi3-mini through the CLI, 2 phases (seq 16 -> 32)
RESUME_ARGV = ["--arch", LM_ARCH, "--optimizer", "sgd", "--scheme", "hybrid",
               "--seq", "32", "--global-batch", "16", "--lr", "5e-3",
               "--steps", "8"]


def b1_store_check(K, rows, rate):
    """B1 (plain: f32 store, no velocity) at the full-width LM's flat-store
    shape: one launch against the plain version (run a slice at a time)
    bit for bit, then timed beside ``add_``, the sliced plain version and
    its bytes bound.  Returns its record."""
    n = rows * 128
    gen = torch.Generator(device="cuda").manual_seed(18)
    w = torch.randn(rows, 128, generator=gen, device="cuda")
    g = torch.randn(rows, 128, generator=gen, device="cuda")
    wk = w.clone()
    slices = [slice(r, r + PLAIN_SLICE_ROWS)
              for r in range(0, rows, PLAIN_SLICE_ROWS)]

    def plain():
        for s in slices:
            K.dbl_apply_plain(w[s], g[s], lr=LR)
    K.dbl_apply_flat2d(wk, g, lr=LR)
    plain()
    torch.cuda.synchronize()
    bad = sum(int((wk[s] != w[s]).sum()) for s in slices)
    err = max(float((wk[s] - w[s]).abs().max()) for s in slices)
    if bad:
        raise AssertionError(f"B1 at the {rows} x 128 store: {bad} elements "
                             f"differ from the plain version (max {err})")
    ms = cuda_ms(lambda: K.dbl_apply_flat2d(wk, g, lr=LR), per_group=5,
                 groups=5, warmup=2)
    lib = lambda: w.add_(g, alpha=-LR)
    library_ms = cuda_ms(lib, per_group=5, groups=5, warmup=2)
    plain_ms = cuda_ms(plain, per_group=1, groups=3, warmup=1)
    bound_ms = max(n * 12 / rate, n * 2 / F32_RATE) * 1e3
    del w, g, wk
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"variant": "plain", "shape": f"{LM_ARCH} store",
           "rows": rows, "elements": n,
           "replaces": f"{REFERENCE}:{B1['plain'][0]}", "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes", "library_ms": library_ms,
           "bytes": n * 12}
    log(f"  dbl_apply_flat2d[plain] at the {LM_ARCH} store ({rows} x 128 "
        f"f32, {n} elements, past 2^31): bit-equal to plain; kernel "
        f"{ms:.2f} ms, add_ {library_ms:.2f} ms, plain (in slices of "
        f"{PLAIN_SLICE_ROWS} rows) {plain_ms:.2f} ms, bound {bound_ms:.2f} "
        f"ms ({bound_ms / ms:.0%} of the memory roofline)")
    return rec


def _lm_counts(L):
    return {"dbl": {k: L.K.launch_count(k) for k in L.K.KERNEL_VARIANTS},
            "dbl_plain": L.K.plain_count(),
            "prefill": sum(m.launch_count() + m.plain_count()
                           for m in L.pf_mods)}


def _reset_lm_counts(L):
    L.K.reset_counts()
    for m in L.pf_mods:
        m.reset_counts()


class _CaptureRun:
    """Around ``launch.train.run``: keep the ``RunResult`` and the engine of
    its ``api.run`` call, and log every step (not every 20th) to a list in
    place of standard output."""

    def __init__(self, train):
        self.train, self.real = train, train.api_run
        self.res = self.engine = None
        self.records = []

    def __enter__(self):
        def api_run(spec, config, **kw):
            import dataclasses
            config = dataclasses.replace(config, log_every=1,
                                         log_fn=self.records.append)
            self.res = self.real(spec, config, **kw)
            self.engine = kw["engine"]
            return self.res
        self.train.api_run = api_run
        return self

    def __exit__(self, *exc):
        self.train.api_run = self.real


def _step_profile(L, engine, fspec, p2, phase, batch):
    """One fused step of ``phase`` on the flat store ``p2``: CUDA-event ms
    (median of 3, after a warm-up), then its kernels under the profiler —
    device busy and idle share, top kernels, B1's share."""
    fn, _ = engine.phase_fn(phase, fspec)
    batches = {k: torch.as_tensor(v)[None].cuda() for k, v in batch.items()}
    step = lambda: fn(p2, None, batches, None)
    step()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        step()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    step_ms = statistics.median(times)
    kern, count, _ = traced_kernels(step, ("dbl_sweep",), 1)
    busy = sum(kern.values()) / 1e3
    b1 = sum(us for n, us in kern.items() if "dbl_sweep" in n) / 1e3
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
    return {"input_size": phase.input_size, "step_ms": step_ms,
            "step_ms_runs": times, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / step_ms, "b1_ms": b1,
            "b1_share": b1 / busy if busy else 0.0,
            "kernel_launches": sum(count.values()),
            "top_kernels": [{"name": n[:90], "ms": us / 1e3,
                             "share": us / 1e3 / busy} for n, us in top]}


def lm_train_phase(L, rate):
    """Phase 18: the LM training main path at full width.  B1 at the
    model's flat-store shape first (the store's geometry read from a
    model built and freed before), then ``launch.train.run`` on
    ``LM_ARGV``: one B1 launch a step and no B4 / B7 / B8, both sequence
    lengths, finite losses, the last below the first, params on the card;
    per sub-stage ms per step, tokens/s, time to its first step, and a
    profiled step; peak memory.  Returns (record, B1's store record)."""
    cfg = L.get_config(LM_ARCH)
    params = L.models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    fspec = L.flat_spec(params)
    rows, n_live = fspec.rows, fspec.n
    del params
    gc.collect()
    torch.cuda.empty_cache()
    b1 = b1_store_check(L.K, rows, rate)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_lm_counts(L)
    t0 = time.perf_counter()
    with _CaptureRun(L.train) as cap:
        hist = L.train.run(LM_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = _lm_counts(L)
    res, engine = cap.res, cap.engine
    losses = [h["loss"] for h in hist]
    seqs = [h["seq"] for h in hist]
    b1_launches = got["dbl"]["dbl_apply_flat2d"]
    if b1_launches != LM_STEPS or sum(got["dbl"].values()) != LM_STEPS \
            or got["dbl_plain"] or got["prefill"]:
        raise AssertionError(f"LM main path: launches {got}; expected one "
                             "dbl_apply_flat2d launch a step and no B4 / B7 "
                             "/ B8 call")
    if len(losses) != LM_STEPS or tuple(sorted(set(seqs))) != LM_SEQS:
        raise AssertionError(f"LM main path: {len(losses)} steps at "
                             f"sequence lengths {sorted(set(seqs))}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"LM main path losses: {losses}")
    if any(t.device.type != "cuda" for t in L.tree_leaves(res.params)) or \
            L.flat_spec(res.params).shape != fspec.shape:
        raise AssertionError("LM params left the card or changed geometry")
    phases = L.train.build_spec(
        L.train.parser().parse_args(LM_ARGV)).to_phases()
    stalls = [s["stall_s"] for s in engine.stall_log]
    sub = []
    for p, ph, stall in zip(res.phases, phases, stalls):
        tokens = ph.layout.effective_examples * ph.input_size
        sub.append({"input_size": p["input_size"], "batch": p["batch_size"],
                    "steps": p["steps"], "time_s": p["time"],
                    "tokens_per_step": tokens,
                    "ms_per_step": 1e3 * p["time"] / p["steps"],
                    "tokens_per_s": tokens * p["steps"] / p["time"],
                    "first_step_s": stall})
    log(f"LM main path: {LM_ARCH} full width ({n_live / 1e9:.3f} B params, "
        f"bf16, remat {cfg.remat}), {LM_STEPS} steps in {wall:.2f} s "
        f"(model build included); peak memory {peak / 2**30:.2f} GiB; "
        f"{b1_launches} dbl_apply_flat2d launches, no B4 / B7 / B8")
    for s in sub:
        log(f"  seq {s['input_size']} x batch {s['batch']}: {s['steps']} "
            f"steps, {s['ms_per_step']:.1f} ms/step, {s['tokens_per_s']:.0f} "
            f"tokens/s ({s['tokens_per_step']:.0f} trained tokens a step), "
            f"first step after {s['first_step_s']:.2f} s")
    log(f"  losses: {losses}")

    # one profiled step per sub-stage on the run's final params
    res.opt_state = None
    p2 = fspec.ravel(res.params)
    res.params = None
    args = L.train.parser().parse_args(LM_ARGV)
    plane = L.DataPlane(L.SyntheticTokens(
        vocab=min(cfg.vocab_size, 256), seed=args.seed,
        n_examples=max(4096, args.global_batch * 64)), seed=args.seed)
    plane.bind(phases)
    profiles, g0 = [], 0
    for ph in phases:
        prof = _step_profile(L, engine, fspec, p2, ph, plane(ph, g0))
        g0 += ph.n_steps
        profiles.append(prof)
        log(f"  profiled step at seq {prof['input_size']}: "
            f"{prof['step_ms']:.1f} ms (CUDA events; runs "
            f"{[round(t, 1) for t in prof['step_ms_runs']]}), device busy "
            f"{prof['device_busy_ms']:.1f} ms (idle "
            f"{prof['device_idle_share']:.1%}), {prof['kernel_launches']} "
            f"kernels; B1 {prof['b1_ms']:.2f} ms ({prof['b1_share']:.1%})")
        for k in prof["top_kernels"]:
            log(f"    {k['ms']:8.3f} ms {k['share']:6.1%}  {k['name']}")
    plane.close()
    del p2
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": LM_ARCH, "argv": LM_ARGV, "params": n_live,
            "store_rows": rows, "wall_s": wall, "peak_bytes": peak,
            "launches": got["dbl"], "losses": losses, "sub_stages": sub,
            "profiles": profiles}, b1


def _train_run(L, cfg, params, form, device):
    """A few dual-batch steps of ``TRAIN_PARITY_ARGS`` through ``api.run``
    on ``device``: ``form`` "fused" (B1 a step), "per_step" (B2 a step) or
    "adamw" (the weighted step).  Returns (RunResult, counts)."""
    import argparse
    spec = L.train.build_spec(argparse.Namespace(**TRAIN_PARITY_ARGS))
    if form == "adamw":
        engine = L.TrainEngine(cfg, L.make_optimizer("adamw",
                                                     weight_decay=0.01),
                               device=device)
    else:
        engine = L.TrainEngine(cfg, L.sgd_momentum(0.0), sgd_server=True,
                               scan_loop="auto" if form == "fused" else False,
                               device=device)
    plane = L.DataPlane(L.SyntheticTokens(vocab=min(cfg.vocab_size, 256),
                                          n_examples=1024), seed=0)
    _reset_lm_counts(L)
    try:
        res = L.api.run(spec, L.api.RunConfig(backend="spmd", log_every=1),
                        init_params=L.tree_map(lambda t: t.to(device),
                                               params),
                        engine=engine, plane=plane)
    finally:
        plane.close()
    return res, _lm_counts(L)


def _leaf_gaps(a, b, rel=False):
    """Max abs gap over leaves of two trees (relative to each leaf's
    largest value of ``b`` with ``rel``)."""
    gaps = []
    for x, y in zip(a, b):
        d = float((x.detach().cpu().float() - y.float()).abs().max())
        gaps.append(d / max(float(y.abs().max()), 1e-30) if rel else d)
    return max(gaps)


def lm_parity_phase(L):
    """Phase 19a: reduced f32 LMs on the card against the CPU port on the
    same init and the same DataPlane data, in the fused (B1), per-step
    (B2) and weighted AdamW forms, within TRAIN_PARITY_BAND.  Returns
    (records, B1 and B2 launches of the card runs)."""
    out, launches = {}, {"dbl_apply_flat2d": 0, "dbl_merge_flat2d": 0}
    want = {"fused": "dbl_apply_flat2d", "per_step": "dbl_merge_flat2d",
            "adamw": None}
    steps = TRAIN_PARITY_ARGS["steps"]
    threads = torch.get_num_threads()
    for arch, layers in TRAIN_PARITY_ARCHS:
        cfg = L.reduced(L.get_config(arch), layers=layers)
        p0 = L.models.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
        gen = torch.Generator().manual_seed(1)
        p_noisy = L.tree_map(lambda t: t * (1 + SENSITIVITY_NOISE * torch.randn(
            t.shape, generator=gen)) if t.is_floating_point() else t, p0)
        for form, kernel in want.items():
            card, cc = _train_run(L, cfg, p0, form, "cuda")
            torch.set_num_threads(1)
            try:
                cpu, _ = _train_run(L, cfg, p0, form, "cpu")
                if form == "adamw":
                    noisy, _ = _train_run(L, cfg, p_noisy, form, "cpu")
            finally:
                torch.set_num_threads(threads)
            n_k = cc["dbl"][kernel] if kernel else 0
            if n_k != (steps if kernel else 0) or \
                    sum(cc["dbl"].values()) != n_k or cc["dbl_plain"] or \
                    cc["prefill"]:
                raise AssertionError(f"{arch} {form} on the card: launches "
                                     f"{cc}")
            if kernel:
                launches[kernel] += n_k
            lc = [h["loss"] for h in card.history]
            lp = [h["loss"] for h in cpu.history]
            pc, pp = L.tree_leaves(card.params), L.tree_leaves(cpu.params)
            rec = {"loss_gap": max(abs(a - b) for a, b in zip(lc, lp)),
                   "param_gap": _leaf_gaps(pc, pp), "losses": lc,
                   "launches": n_k}
            ok = len(lc) == len(lp) == steps and \
                all(t.device.type == "cuda" for t in pc)
            if form == "adamw":
                moments = lambda a, b: max(
                    _leaf_gaps(L.tree_leaves(a.opt_state[k]),
                               L.tree_leaves(b.opt_state[k]), rel=True)
                    for k in ("m", "v"))
                rec["moment_gap"] = moments(card, cpu)
                sens = rec["sensitivity"] = {
                    "loss_gap": max(abs(a - h["loss"]) for a, h in
                                    zip(lp, noisy.history)),
                    "param_gap": _leaf_gaps(L.tree_leaves(noisy.params), pp),
                    "moment_gap": moments(noisy, cpu)}
                k = TRAIN_PARITY_BAND["sensitivity"]
                ok = ok and rec["loss_gap"] <= max(
                    TRAIN_PARITY_BAND["loss"], k * sens["loss_gap"]) and \
                    rec["param_gap"] <= k * sens["param_gap"] and \
                    rec["moment_gap"] <= k * sens["moment_gap"]
            else:
                ok = ok and rec["loss_gap"] <= TRAIN_PARITY_BAND["loss"] \
                    and rec["param_gap"] <= TRAIN_PARITY_BAND["params"]
            out[f"{arch}/{form}"] = rec
            extra = (f", moments {rec['moment_gap']:.3g} (relative); the CPU "
                     f"port's own gaps from {SENSITIVITY_NOISE:g} noise: loss "
                     f"{rec['sensitivity']['loss_gap']:.3g}, params "
                     f"{rec['sensitivity']['param_gap']:.3g}, moments "
                     f"{rec['sensitivity']['moment_gap']:.3g}"
                     if form == "adamw" else "")
            log(f"LM parity {arch} reduced ({layers} layers, f32) {form}, "
                f"card vs CPU over {steps} steps: loss gap "
                f"{rec['loss_gap']:.3g}, param gap {rec['param_gap']:.3g}"
                f"{extra}; {n_k} {kernel or 'kernel'} launches")
            if not ok:
                raise AssertionError(f"{arch} {form}: the card and the CPU "
                                     f"port disagree beyond "
                                     f"{TRAIN_PARITY_BAND}: {rec}")
    return out, launches


def _resume_pair(L, tmp, tag):
    """The CLI through all phases with ``--ckpt``, then ``--resume`` from
    the middle boundary in a directory holding only that file; returns
    (full run's final file, resumed run's final file, printed lines, B1
    launches)."""
    import contextlib
    import io
    import shutil
    full = os.path.join(tmp, f"{tag}-full")
    part = os.path.join(tmp, f"{tag}-part")
    text = io.StringIO()
    _reset_lm_counts(L)
    with contextlib.redirect_stdout(text):
        L.train.run(RESUME_ARGV + ["--ckpt", full])
        os.makedirs(part)
        shutil.copy(os.path.join(full, "ckpt_00000001.npz"), part)
        L.train.run(RESUME_ARGV + ["--ckpt", part, "--resume"])
    n = L.K.launch_count("dbl_apply_flat2d")
    return (os.path.join(full, "ckpt_00000002.npz"),
            os.path.join(part, "ckpt_00000002.npz"), text.getvalue(), n)


def lm_resume_phase(L):
    """Phase 19b: reduced phi3-mini through ``launch.train.run`` with
    ``--ckpt`` over both phases, then ``--resume`` from the middle
    boundary: the resumed run's final checkpoint equals the uninterrupted
    run's bit for bit (under ``torch.use_deterministic_algorithms`` if
    the card's default kernels do not repeat themselves)."""
    import numpy as np
    import tempfile

    def same(f1, f2):
        with np.load(f1) as a, np.load(f2) as b:
            return sorted(a.files) == sorted(b.files) and all(
                np.array_equal(a[k], b[k]) for k in a.files)
    with tempfile.TemporaryDirectory() as tmp:
        f_full, f_res, text, n = _resume_pair(L, tmp, "default")
        equal = same(f_full, f_res)
        deterministic = False
        if not equal:
            log("LM resume: the resumed run differs on the default kernels; "
                "again under torch.use_deterministic_algorithms(True)")
            os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
            torch.use_deterministic_algorithms(True)
            try:
                f_full, f_res, text, n = _resume_pair(L, tmp, "det")
            finally:
                torch.use_deterministic_algorithms(False)
            equal, deterministic = same(f_full, f_res), True
        with np.load(f_full) as a:
            n_leaves = len(a.files)
    resumed = "# resumed from phase boundary 1" in text
    log(f"LM resume (reduced {LM_ARCH}, {' '.join(RESUME_ARGV[2:])}): final "
        f"checkpoint of the run resumed at boundary 1 "
        f"{'equals' if equal else 'differs from'} the uninterrupted run's "
        f"({n_leaves} leaves){' on deterministic kernels' if deterministic else ''}"
        f"; {n} dbl_apply_flat2d launches over both runs")
    if not (equal and resumed):
        raise AssertionError("the resumed run does not replay the "
                             "uninterrupted one")
    return {"equal": equal, "deterministic": deterministic,
            "leaves": n_leaves, "launches": n}


# ------------------------------ phase 20: the autotuner ---------------------
BATCHED = "dbl_apply_worker_batched"
# the batched form replaces B3 under jax.vmap (dbl_apply_worker_xla)
BATCHED_LINE = 388
# per candidate: lr, update factor, momentum — distinct, so that a kernel
# reading another candidate's scalars fails the check
BATCHED_SCALARS = ((0.05, 0.01, 0.3), (0.9365079365079365, 1.0, 0.5),
                   (0.9, 0.0, 0.5))
BATCHED_CANDIDATES = (1, 3)
# the tuner's main path: combined_space (the Table 3 factor, Table 5
# small-worker and Table 8 ladder axes, and a k axis) on the repo's PS
# problem (32 px, B_L 64, 2048 images, 4 workers under ASP, lr 0.05) at the
# full width of cifar-resnet18, cut from 16 epochs to 4; the replay tags,
# group size and run_key the reference gives on the same search
TUNE_EPOCHS = 4
TUNE_BUDGET = 1.5
TUNE_RUN_KEY = "f27f41f24570"
TUNE_REPLAY = {"base": "batched:3", "nS0": "api", "nS1": "api",
               "nS2": "api", "nS4": "api", "k1.1": "api", "k1.5": "",
               "f_sqrt": "batched:3", "f_none": "batched:3",
               "ladder24x32": "api"}
TUNE_GROUP_EVENTS = 156
# card vs CPU: combined_space's axes at width 8 on 8 px (64 images of a
# 128-image set, batch 8, 2 epochs; ladder 4 -> 8 px).  At width 8 the
# 4 px rung costs a quarter of the 8 px one, so the ladder is predicted
# 4.1x faster than the slowest flat candidate but k1.5: a budget of 5x
# prunes k1.5 (5.7x) alone, as 1.5x does at full width.
TUNE_SMALL_BASE = dict(epochs=2, input_size=8, dataset_size=64, batch_size=8)
TUNE_SMALL_AXES = dict(n_small=(0, 1, 2, 4), factor=("sqrt", "none"),
                       k=(1.1, 1.5), ladders=((4, 8),))
TUNE_SMALL_BUDGET = 5.0
TUNE_SMALL_SOURCE = dict(n_train=128, n_test=16, num_classes=10, seed=0)


def _batched_buffers(rows, n_cand, master, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *lead: torch.randn(*lead, rows, 128, generator=gen,
                                    device="cuda")
    b = {"w": rnd(n_cand), "g": rnd(n_cand),
         "v": rnd(n_cand, B3_WORKERS.get(rows, N_WORKERS))}
    if master:
        b["shadow"] = b["w"].to(torch.bfloat16)
    return b


def _batched_call(K, b, scal, master, form):
    """One event for every candidate of ``b``, in place: the batched kernel
    (``kernel``), its plain version (``plain``), or C launches of the
    one-store B3 with each candidate's scalars as host numbers
    (``single``, from ``BATCHED_SCALARS``: reading ``scal`` back would
    wait for the card)."""
    if form == "single":
        host = BATCHED_SCALARS
        for c in range(b["w"].shape[0]):
            args = (b["g"][c], b["v"][c], WID, host[0][c], host[1][c],
                    host[2][c])
            if master:
                K.dbl_apply_worker_flat2d(b["shadow"][c], *args,
                                          master2=b["w"][c])
            else:
                K.dbl_apply_worker_flat2d(b["w"][c], *args)
        return
    fn = K.dbl_apply_worker_batched if form == "kernel" \
        else K.dbl_apply_worker_batched_plain
    if master:
        fn(b["shadow"], b["g"], b["v"], WID, *scal, masterC=b["w"])
    else:
        fn(b["w"], b["g"], b["v"], WID, *scal)


def _batched_check(K, rows, n_cand, master, seed):
    """The batched kernel, its plain version and C one-store B3 launches on
    the same inputs; raises unless all three agree bit for bit, only row
    block (c, wid) of each candidate's velocity changed, and the bf16
    shadow is the rounded master.  Returns (the kernel's buffers, the
    scalars, the largest difference from the plain version)."""
    scal = [torch.tensor(s[:n_cand], dtype=torch.float32, device="cuda")
            for s in BATCHED_SCALARS]
    ref = _batched_buffers(rows, n_cand, master, seed)
    before = ref["v"].clone()
    out = {form: {k: t.clone() for k, t in ref.items()}
           for form in ("plain", "single")}
    _batched_call(K, ref, scal, master, "kernel")
    for form, b in out.items():
        _batched_call(K, b, scal, master, form)
    torch.cuda.synchronize()
    tag = (f"{BATCHED}[{'master' if master else 'plain'}] C={n_cand} at "
           f"{rows} rows")
    gaps = {(form, name): float((ref[name].float() - b[name].float()).abs()
                                .max())
            for form, b in out.items() for name in ref}
    if any(gaps.values()):
        raise AssertionError(f"{tag}: kernel differs from its plain version "
                             f"or from {WORKER}: {gaps}")
    for c in range(n_cand):
        for i in range(before.shape[1]):
            if torch.equal(ref["v"][c, i], before[c, i]) != (i != WID):
                raise AssertionError(f"{tag}: candidate {c}'s velocity rows "
                                     f"of worker {i} changed wrongly")
    if master and not torch.equal(ref["shadow"],
                                  ref["w"].to(torch.bfloat16)):
        raise AssertionError(f"{tag}: bf16 shadow is not the rounded master")
    if n_cand > 1 and rows == CHECK_ROWS[0]:
        # the check can fail: every candidate on candidate 0's scalars
        # differs from the kernel at every other candidate
        wrong = _batched_buffers(rows, n_cand, master, seed)
        _batched_call(K, wrong, [s[:1].repeat(n_cand) for s in scal],
                      master, "plain")
        if any(torch.equal(wrong["w"][c], ref["w"][c])
               for c in range(1, n_cand)):
            raise AssertionError(f"{tag}: candidate 0's scalars give the "
                                 "other candidates' results")
    return ref, scal, max(gaps.values())


def batched_kernel_phase(K, rows: int, rate: float):
    """Phase 20 (a): B3's candidate-batched form, f32 and master, at C = 1
    and 3, held bit-equal to its plain version and to C one-store B3
    launches at ``CHECK_ROWS`` and the full store, then timed at C = 3 on
    the full store beside three back-to-back B3 launches, its plain
    version and its bytes bound (C times B3's)."""
    out = []
    n = rows * 128
    for vi, (variant, (_, nbytes, _)) in enumerate(B3.items()):
        master = variant == "master"
        err = 0.0
        for n_cand in BATCHED_CANDIDATES:
            for r in CHECK_ROWS + (rows,):
                ref, scal, gap = _batched_check(K, r, n_cand, master,
                                                seed=r + n_cand + vi)
                err = max(err, gap)
        n_cand = BATCHED_CANDIDATES[-1]
        single = {k: t.clone() for k, t in ref.items()}
        plain = {k: t.clone() for k, t in ref.items()}
        ms = cuda_ms(lambda: _batched_call(K, ref, scal, master, "kernel"))
        single_ms = cuda_ms(lambda: _batched_call(K, single, scal, master,
                                                  "single"))
        plain_ms = cuda_ms(lambda: _batched_call(K, plain, scal, master,
                                                 "plain"))
        fused_ms = None
        if not master:
            # SGD with momentum at lr f·lr, once per candidate: the same
            # bytes, rounded otherwise (a note: no one call does all C;
            # it takes no momentum of 0, so every call runs at MOM)
            lr, fac, _ = (t.tolist() for t in scal)
            fused_ms = cuda_ms(lambda: [torch._fused_sgd_(
                [single["w"][c]], [single["g"][c]], [single["v"][c, WID]],
                weight_decay=0.0, momentum=MOM, lr=fac[c] * lr[c],
                dampening=0.0, nesterov=False, maximize=False,
                is_first_step=False) for c in range(n_cand)])
        bound_ms = n_cand * n * nbytes / rate * 1e3
        rec = {"variant": "batched" if not master else "batched_master",
               "candidates": n_cand,
               "replaces": f"{REFERENCE}:{BATCHED_LINE}",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "single_x3_ms": single_ms, "bound_ms": bound_ms,
               "bound_by": "bytes", "library_ms": None,
               "fused_sgd_x3_ms": fused_ms, "bytes": n_cand * n * nbytes}
        out.append(rec)
        log(f"  {BATCHED}[{variant}]: bit-equal to plain and to C {WORKER} "
            f"launches at C = {BATCHED_CANDIDATES} and "
            f"{CHECK_ROWS + (rows,)} rows; C = {n_cand}: kernel "
            f"{ms * 1e3:.1f} us, {n_cand} single launches "
            f"{single_ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us"
            + ("" if fused_ms is None else
               f", {n_cand} _fused_sgd_ {fused_ms * 1e3:.1f} us")
            + f", bound {bound_ms * 1e3:.1f} us "
            f"({bound_ms / ms:.0%} of the memory roofline)")
        del ref, single, plain
    torch.cuda.empty_cache()
    return out


class RecordedProblem:
    """The tuner's problem over ResNet-18 ``cfg`` on ``source`` (the port's
    seeded ``init_params``, ``make_fns_factory`` and ``DataPlane``, as
    phase 7 builds them), recording what the tuner made of it: whether
    TF32 was on at each gradient and, at each evaluation in call order,
    where the params lived, what it returned and (``keep``) a CPU copy of
    the params.  ``init_cpu(seed)`` gives initial params to copy to
    ``device``; without it they are drawn there."""

    def __init__(self, m, cfg, source, device, *, init_cpu=None,
                 keep=False):
        self.tf32, self.evals, self.planes = [], [], {}
        factory = m.make_fns_factory(cfg, source, device)
        inits, fns = {}, {}

        def init_for(seed):
            if seed not in inits:
                inits[seed] = (m.models.init_params(
                    cfg, torch.Generator().manual_seed(seed), device=device)
                    if init_cpu is None else m.tree_map(
                        lambda t: t.to(device), init_cpu(seed)))
            return inits[seed]

        def fns_for(seed, size):
            if size not in fns:
                grad_fn, _, eval_fn = factory(size)

                def grad(p, b):
                    self.tf32.append(torch.backends.cudnn.allow_tf32 or
                                     torch.backends.cuda.matmul.allow_tf32)
                    return grad_fn(p, b)

                def evaluate(p):
                    out = eval_fn(p)
                    leaves = m.tree_leaves(p)
                    self.evals.append({
                        "devices": {t.device.type for t in leaves},
                        "metrics": out,
                        "params": [t.detach().cpu().clone() for t in leaves]
                        if keep else None})
                    return out
                fns[size] = (grad, None, evaluate)
            return fns[size]

        def plane_for(seed):
            if seed not in self.planes:
                self.planes[seed] = m.DataPlane(source, seed=seed)
            return self.planes[seed]
        self.problem = m.tune.TuneProblem(init_for=init_for, fns_for=fns_for,
                                          plane_for=plane_for)

    def close(self):
        for plane in self.planes.values():
            plane.close()


def _tune_events(m, cand) -> int:
    """Events of one candidate's replay, from its traces (the schedule pass
    is host-only): its one trace, or each phase's as the backend builds
    them."""
    tr = m.single_phase_trace(cand)
    if tr is not None:
        return tr.n_events
    return sum(t.n_events for t in phase_traces(m, cand.spec))


def profile_tune_events(m, cfg, source, n: int = 8):
    """Host and device time of the tuner's replay events at 32 px x 64
    images, on a batch already on the card: ``n`` events of one candidate
    (a gradient and a B3 launch, ``execute_trace``'s event) and ``n``
    events of a batched group of three (three gradients and one batched
    launch, ``execute_trace_batched``'s), each traced after two warm-up
    events."""
    params = m.models.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cuda")
    spec = m.flat_spec(params)
    grad_fn = m.make_fns_factory(cfg, source, "cuda")(32)[0]
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in source.batch_at(list(range(64)), 32).items()}
    n_cand = 3
    p2 = spec.ravel(params)
    vel3 = spec.zeros_stacked(N_WORKERS, device="cuda")
    pC = torch.stack([p2] * n_cand)
    velC = spec.zeros_candidates(n_cand, N_WORKERS, device="cuda")
    scal = [torch.full((n_cand,), x, device="cuda")
            for x in (1e-4, FACTOR, MOM)]
    solo = m.make_event(grad_fn, spec, "auto")
    batched = m.make_batched_event(grad_fn, spec, torch.empty_like(pC))
    forms = {"solo": (1, lambda: solo(p2, vel3, batch, 64, WID, 1e-4,
                                      FACTOR, MOM)),
             "batched": (n_cand, lambda: batched(pC, velC, [batch] * n_cand,
                                                 64, WID, *scal))}
    out = {}
    for name, (c, event) in forms.items():
        for _ in range(2):
            event()
        torch.cuda.synchronize()

        def events():
            for _ in range(n):
                event()
        kern, _, wall = traced_kernels(events)
        busy_us = sum(kern.values())
        out[name] = {"candidates": c,
                     "ms_per_candidate_event": 1e3 * wall / n / c,
                     "device_busy_ms_per_candidate_event":
                         busy_us / 1e3 / n / c,
                     "device_idle_share": 1.0 - busy_us / 1e6 / wall}
        log(f"  {name} event profile (32 px x 64 images, staged, {c} "
            f"candidate(s)): {out[name]['ms_per_candidate_event']:.2f} ms "
            f"a candidate-event, device busy "
            f"{out[name]['device_busy_ms_per_candidate_event']:.2f} ms "
            f"(idle {out[name]['device_idle_share']:.0%})")
    return out


def _replay_walls(marks, end):
    """Wall seconds of each replay of one search, from the tuner's log
    lines: each replay starts with one ("batched replay: ..." for a group,
    "replaying <label> via api.run" for one candidate) and ends where the
    next starts (the last at ``end``); a replay ends in an evaluation,
    which reads its loss back from the card."""
    starts = [(t, msg) for t, msg in marks
              if msg.startswith(("batched replay", "replaying"))]
    ends = [t for t, _ in starts[1:]] + [end]
    return {(msg.split()[1] if msg.startswith("replaying") else "group"):
            e - t for (t, msg), e in zip(starts, ends)}


def tune_phase(m, cfg):
    """Phase 20 (b) and (c): the tuner's main path at full width, then its
    batched group against its candidates' sequential replays on cuDNN's
    deterministic kernels, and a profile of both replays' events."""
    source = m.SyntheticImages(n_train=2048, n_test=512, num_classes=100)
    rp = RecordedProblem(m, cfg, source, "cuda")
    marks = []
    # TF32 on when the search starts: the batched replay runs first and
    # must turn it off itself (PsSimBackend does so for the api path)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m.K.reset_counts()
    t0 = time.perf_counter()
    res = m.tune.autotune(
        m.tune.combined_space(epochs=TUNE_EPOCHS, seed=0), rp.problem,
        budget_ratio=TUNE_BUDGET,
        log=lambda s: marks.append((time.perf_counter(), s)))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    launches = {k: m.K.launch_count(k) for k in (WORKER, BATCHED)}
    plain_runs = m.K.plain_count()
    replay = {c.label: c.replay for c in res.candidates}
    if replay != TUNE_REPLAY:
        raise AssertionError(f"replay tags {replay}, expected {TUNE_REPLAY}")
    analytic = m.tune.autotune(
        m.tune.combined_space(epochs=TUNE_EPOCHS, seed=0), None,
        validate=False, budget_ratio=TUNE_BUDGET)
    if res.run_key() != analytic.run_key() or \
            res.run_key() != TUNE_RUN_KEY:
        raise AssertionError(f"run_key {res.run_key()}, the analytic run's "
                             f"{analytic.run_key()}, expected {TUNE_RUN_KEY}")
    live = [c for c in res.candidates if not c.pruned]
    if not all(c.accuracy is not None and math.isfinite(c.accuracy) and
               math.isfinite(c.test_loss) for c in live):
        raise AssertionError("a validated candidate has no finite accuracy "
                             "and loss: " + str([(c.label, c.accuracy,
                                                  c.test_loss) for c in live]))
    if not res.front:
        raise AssertionError("empty Pareto front")
    group = [c for c in res.candidates if c.replay.startswith("batched")]
    events = {c.label: _tune_events(m, c) for c in live}
    solo = sum(n for lb, n in events.items() if TUNE_REPLAY[lb] == "api")
    if events["base"] != TUNE_GROUP_EVENTS or \
            launches[BATCHED] != events["base"] or \
            launches[WORKER] != solo or plain_runs:
        raise AssertionError(
            f"launches {launches}, plain runs {plain_runs}: expected one "
            f"{BATCHED} launch per event of the group ({events['base']} "
            f"events, expected {TUNE_GROUP_EVENTS}) and one {WORKER} launch "
            f"per event of the api candidates ({solo}: {events})")
    if any(rp.tf32) or torch.backends.cudnn.allow_tf32:
        raise AssertionError("a gradient of the search ran with TF32 on")
    if any(e["devices"] != {"cuda"} for e in rp.evals):
        raise AssertionError("the search evaluated params off the card")
    walls = _replay_walls(marks, t1)
    per = {lb: {"wall_s": walls[lb], "events": n,
                "ms_per_event": 1e3 * walls[lb] / n}
           for lb, n in events.items() if TUNE_REPLAY[lb] == "api"}
    per["batched"] = {"wall_s": walls["group"], "candidates": len(group),
                      "events": events["base"],
                      "s_per_candidate": walls["group"] / len(group),
                      "ms_per_candidate_event": 1e3 * walls["group"]
                      / len(group) / events["base"]}
    log(f"tuner main path (combined_space, {TUNE_EPOCHS} epochs, "
        f"cifar-resnet18, d_model {cfg.d_model}): {len(res.candidates)} "
        f"candidates, pruned "
        f"{[c.label for c in res.candidates if c.pruned]}, run_key "
        f"{res.run_key()}, front {res.front_labels}; {t1 - t0:.1f} s, peak "
        f"{peak / 2**30:.2f} GiB; {launches[BATCHED]} {BATCHED} + "
        f"{launches[WORKER]} {WORKER} launches, no plain run, TF32 off")
    log(f"  batched group {[c.label for c in group]}: "
        f"{per['batched']['wall_s']:.2f} s, "
        f"{per['batched']['s_per_candidate']:.2f} s a candidate, "
        f"{per['batched']['ms_per_candidate_event']:.2f} ms a "
        f"candidate-event over {events['base']} events")
    for lb, p in per.items():
        if lb != "batched":
            log(f"  {lb} via api: {p['events']} events in {p['wall_s']:.2f} "
                f"s ({p['ms_per_event']:.2f} ms/event)")
    for c in res.candidates:
        log(f"    {c.label:12s} predicted {c.predicted_time:.3f} cost "
            f"{c.cost:.3f} sim {c.sim_time} acc {c.accuracy} loss "
            f"{c.test_loss} {c.replay or 'pruned'}")

    # (c) the group alone, batched and each candidate sequentially, on
    # cuDNN's deterministic kernels: bit for bit
    traces = [m.single_phase_trace(c) for c in group]
    inits = [rp.problem.init_for(c.spec.seed) for c in group]
    grad_fn = rp.problem.fns_for(0, group[0].spec.input_size)[0]
    phase = group[0].spec.to_phases()[0]
    plane = rp.problem.plane_for(0)
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize()
        d0 = time.perf_counter()
        bat = m.execute_trace_batched(
            inits, grad_fn, traces, feed=plane.trace_feed(0, phase, "cuda"))
        torch.cuda.synchronize()
        d1 = time.perf_counter()
        seq = [m.execute_trace(p0, grad_fn, tr,
                               feed=plane.trace_feed(0, phase, "cuda"))
               for p0, tr in zip(inits, traces)]
        torch.cuda.synchronize()
        d2 = time.perf_counter()
    finally:
        torch.backends.cudnn.deterministic = False
        rp.close()
    gaps = [param_gap(m, b.params, s.params) for b, s in zip(bat, seq)]
    det = {"batched_s": d1 - d0, "sequential_s": d2 - d1,
           "batched_candidate_s": (d1 - d0) / len(group),
           "seq_candidate_s": (d2 - d1) / len(group), "param_gaps": gaps}
    log(f"  deterministic cuDNN: batched {det['batched_s']:.2f} s "
        f"({det['batched_candidate_s']:.2f} s a candidate), sequential "
        f"{det['sequential_s']:.2f} s ({det['seq_candidate_s']:.2f} s a "
        f"candidate); batched vs sequential param gaps {gaps}")
    if any(gaps) or any(t.device.type != "cuda" for b in bat
                        for t in m.tree_leaves(b.params)):
        raise AssertionError(f"batched vs sequential params differ: {gaps}")
    return {"candidates": json.loads(res.to_json())["candidates"],
            "front": res.front_labels, "run_key": res.run_key(),
            "wall_s": t1 - t0, "peak_bytes": peak, "launches": launches,
            "replays": per, "deterministic": det,
            "event_profile": profile_tune_events(m, cfg, source)}


def tune_parity_phase(m, small):
    """Phase 20 (d): the width-8 search on the card and on the CPU port
    from the same initial params: the same labels, pruning and replay tags,
    equal sim_times, and every evaluation's loss and params within
    ``PS_PARITY_BAND``."""
    source = m.SyntheticImages(**TUNE_SMALL_SOURCE)
    p0 = {}

    def init_cpu(seed):
        if seed not in p0:
            p0[seed] = m.models.init_params(
                small, torch.Generator().manual_seed(seed), device="cpu")
        return p0[seed]
    space = m.tune.SearchSpace(base=m.tune.base_spec(**TUNE_SMALL_BASE),
                               **TUNE_SMALL_AXES)
    runs, threads = {}, torch.get_num_threads()
    for dev in ("cuda", "cpu"):
        rp = RecordedProblem(m, small, source, dev, init_cpu=init_cpu,
                             keep=True)
        m.K.reset_counts()
        if dev == "cpu":
            torch.set_num_threads(1)
        t0 = time.perf_counter()
        try:
            res = m.tune.autotune(space, rp.problem,
                                  budget_ratio=TUNE_SMALL_BUDGET, device=dev)
        finally:
            torch.set_num_threads(threads)
            rp.close()
        runs[dev] = {"res": res, "evals": rp.evals,
                     "wall_s": time.perf_counter() - t0,
                     "launches": m.K.launch_count(),
                     "plain": m.K.plain_count()}
    card, cpu = runs["cuda"], runs["cpu"]

    def facts(r):
        return [(c.label, c.pruned, c.replay, c.sim_time)
                for c in r["res"].candidates]
    if facts(card) != facts(cpu):
        raise AssertionError(f"card {facts(card)} != CPU {facts(cpu)}")
    tags = {c.replay for c in card["res"].candidates}
    if not any(t.startswith("batched") for t in tags) or "api" not in tags \
            or [c.label for c in card["res"].candidates if c.pruned] \
            != ["k1.5"]:
        raise AssertionError(f"width-8 search: replays {tags}")
    if card["plain"] or not card["launches"] or cpu["launches"]:
        raise AssertionError(f"launches / plain runs: card "
                             f"{card['launches']} / {card['plain']}, CPU "
                             f"{cpu['launches']} / {cpu['plain']}")
    if len(card["evals"]) != len(cpu["evals"]):
        raise AssertionError("the card and the CPU evaluated "
                             f"{len(card['evals'])} / {len(cpu['evals'])} "
                             "times")
    loss_gap = max(abs(a["metrics"]["test_loss"] - b["metrics"]["test_loss"])
                   for a, b in zip(card["evals"], cpu["evals"]))
    pgap = max(float((x - y).abs().max()) for a, b in
               zip(card["evals"], cpu["evals"])
               for x, y in zip(a["params"], b["params"]))
    log(f"tuner parity (width 8, 8 px): {len(card['res'].candidates)} "
        f"candidates, replays {sorted(tags)}, {len(card['evals'])} "
        f"evaluations; card {card['wall_s']:.2f} s, CPU {cpu['wall_s']:.2f} "
        f"s; loss gap {loss_gap:.3g}, param gap {pgap:.3g} (bands "
        f"{PS_PARITY_BAND['loss']:g} / {PS_PARITY_BAND['params']:g})")
    if loss_gap > PS_PARITY_BAND["loss"] or pgap > PS_PARITY_BAND["params"]:
        raise AssertionError("the card and the CPU port disagree on the "
                             "width-8 search")
    return {"facts": facts(card), "evaluations": len(card["evals"]),
            "loss_gap": loss_gap, "param_gap": pgap,
            "card_s": card["wall_s"], "cpu_s": cpu["wall_s"],
            "launches": card["launches"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()
    t_start = time.perf_counter()

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
    from repro_torch.models import resnet
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
    from repro_torch.cluster.trace import (_make_batched_event, _make_event,
                                           execute_trace,
                                           execute_trace_batched)
    from repro_torch.examples.train_resnet18_e2e import make_fns_factory
    from repro_torch import tune
    from repro_torch.tune.autotune import _single_phase_trace
    m = SimpleNamespace(api=api, models=models, TrainEngine=TrainEngine,
                        sgd_momentum=sgd_momentum, K=K,
                        tree_leaves=tree_leaves, tree_map=tree_map,
                        DataPlane=DataPlane, SyntheticImages=SyntheticImages,
                        schedule_pass=schedule_pass,
                        workers_from_plan=workers_from_plan,
                        phase_seed=phase_seed,
                        scaled_time_model=scaled_time_model,
                        chunk_ranges=_chunk_ranges, flat_spec=flat_spec,
                        tune=tune, single_phase_trace=_single_phase_trace,
                        execute_trace=execute_trace,
                        execute_trace_batched=execute_trace_batched,
                        make_event=_make_event,
                        make_batched_event=_make_batched_event,
                        make_fns_factory=make_fns_factory)
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

    # 5. parity on a small input: the card against the CPU port, the CPU
    # run taking every ReLU kink on the side the card run took
    small = replace(cfg, d_model=8, vocab_size=10)
    sspec = _spec(api, **PARITY_SPEC)
    ssrc = SyntheticImages(**PARITY_SOURCE)
    p0 = models.init_params(small, torch.Generator().manual_seed(0),
                            device="cpu")
    sides = {leg: ReluSides() for leg in ("card", "tf32")}
    runs = {leg: s.record(resnet, lambda: drive(
                m, sspec, small, device="cuda", source=ssrc,
                params=tree_map(lambda t: t.cuda(), p0), tf32=leg == "tf32"))
            for leg, s in sides.items()}

    def cpu_run():
        return drive(m, sspec, small, device="cpu", source=ssrc,
                     params=tree_map(lambda t: t.clone(), p0))
    # one CPU thread: multi-threaded oneDNN conv backward has aborted the
    # process on small ResNets (and the CPU tests run it so too)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu = {leg: s.replay(resnet, cpu_run) for leg, s in sides.items()}
        free = cpu_run()
    finally:
        torch.set_num_threads(threads)

    def gaps(r, ref):
        """(largest loss gap, largest param gap) of a card run vs a CPU
        run; the losses are the history's, rounded to 4 decimals."""
        return (max(abs(a - b) for a, b in zip(r["losses"], ref["losses"])),
                max(float((a.cpu() - b).abs().max()) for a, b in
                    zip(tree_leaves(r["res"].params),
                        tree_leaves(ref["res"].params))))
    report["parity"] = {}
    for leg, r in runs.items():
        loss_gap, pgap = gaps(r, cpu[leg])
        free_loss, free_params = gaps(r, free)
        inside = loss_gap <= PARITY_BAND["loss"] and \
            pgap <= PARITY_BAND["params"]
        report["parity"][leg] = {
            "loss_gap": loss_gap, "param_gap": pgap, "inside_band": inside,
            "relu_calls": len(sides[leg].masks),
            "other_side_units": sides[leg].other_side,
            "free_loss_gap": free_loss, "free_param_gap": free_params}
        log(f"parity (width 8, lr 0.005, 6 steps), {leg} vs CPU on the "
            f"{leg} run's kink sides: loss gap {loss_gap:.3g}, param gap "
            f"{pgap:.3g} (bands {PARITY_BAND['loss']:g} / "
            f"{PARITY_BAND['params']:g}): "
            f"{'inside' if inside else 'outside'}; the CPU would have taken "
            f"{sides[leg].other_side} ReLU units of "
            f"{len(sides[leg].masks)} calls to the other side; vs the "
            f"free CPU run: loss gap {free_loss:.3g}, param gap "
            f"{free_params:.3g} (not held)")
    if not report["parity"]["card"]["inside_band"]:
        raise AssertionError(f"the card and the CPU port disagree: "
                             f"{report['parity']['card']}")
    if report["parity"]["tf32"]["inside_band"]:
        raise AssertionError(f"the planted TF32 fault lands inside the "
                             f"parity band: {report['parity']['tf32']}")

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
    # 11. B5 and B6 against their plain versions, and their times
    from repro_torch import serve as serve_pkg
    from repro_torch.configs import reduced
    from repro_torch.kernels import flash_decode as FD
    fd_recs = fd_kernel_phase(FD, rate)
    log(f"[{time.perf_counter() - t_start:.0f} s] B5/B6 checked")

    # 12. the serving main path at full width, then 13. card vs CPU
    S = SimpleNamespace(FD=FD, models=models, get_config=get_config,
                        reduced=reduced, tree_leaves=tree_leaves,
                        tree_map=tree_map, **{n: getattr(serve_pkg, n)
                                              for n in serve_pkg.__all__})
    report["serving"], serve_launches = serving_phase(S)
    log(f"[{time.perf_counter() - t_start:.0f} s] serving main path done")
    report["serve_parity"] = serve_parity_phase(S)
    for kernel, fn_line in FD_INFO.items():
        recs = fd_recs[kernel]
        # the main path's form: phi3 geometry, bf16 q, f32 cache, window 0
        main = next(r for r in recs if r["shape"] == SERVE_ARCH and
                    r["q"] == "bfloat16" and r["cache"] == "float32" and
                    "ms" in r)
        launches = sum(serve_launches[kernel].values())
        line.append({
            "name": kernel, "route": "cuda", "source": FD_CSRC,
            "replaces": f"{FD_REFERENCE}:{fn_line}", "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "variants": recs})

    # 14. B4, B7 and B8 against their plain versions, and their times
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mamba_scan as SSD
    from repro_torch.kernels import ops as ops_mod
    from repro_torch.kernels import wkv6 as WKV
    from repro_torch.kernels.ref import dbl_merge_ref
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import layout
    pf_mods = {"flash_attention": FA, "mamba_ssd_scan": SSD,
               "wkv6_chunked": WKV}

    def reset_pf():
        for mod in pf_mods.values():
            mod.reset_counts()

    def pf_counts():
        return {"launches": {k: mod.launch_count(k)
                             for k, mod in pf_mods.items()},
                "plain": sum(mod.plain_count() for mod in pf_mods.values())}
    P = SimpleNamespace(FA=FA, SSD=SSD, WKV=WKV, ops=ops_mod, models=models,
                        get_config=get_config, reduced=reduced, layout=layout,
                        tree_leaves=tree_leaves, tree_map=tree_map,
                        make_prefill_step=make_prefill_step,
                        reset_counts=reset_pf, counts=pf_counts,
                        dbl_merge_ref=dbl_merge_ref)
    pf_recs = pf_kernel_phase(P, rate)
    log(f"[{time.perf_counter() - t_start:.0f} s] B4/B7/B8 checked")
    # 15. the prefill main path at full width, 16. card vs CPU, 17. ops
    report["prefill"], pf_launches = prefill_phase(P)
    log(f"[{time.perf_counter() - t_start:.0f} s] prefill main path done")
    report["prefill_parity"] = prefill_parity_phase(P)
    report["ops"] = ops_phase(P)
    # the main path's form of each: B4 bf16 at zamba2's shared attention,
    # B7 bf16 at zamba2's SSD on the block's views, B8 on time_mix's bf16
    # views with an f32 decay and output at rwkv6's
    main_form = {"flash_attention": ("zamba2-2.7b", "bfloat16"),
                 "mamba_ssd_scan": (SSD_VIEWS, "bfloat16"),
                 "wkv6_chunked": (WKV_VIEWS, "bfloat16")}
    for kernel, (ref_file, fn_line) in PF_REFERENCE.items():
        recs = pf_recs[kernel]
        shape, dtype = main_form[kernel]
        main = next(r for r in recs if r["shape"] == shape and
                    r["dtype"] == dtype and "ms" in r)
        line.append({
            "name": kernel, "route": "cuda", "source": PF_CSRC[kernel],
            "replaces": f"{ref_file}:{fn_line}",
            "launches": pf_launches[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "variants": recs})

    # 18. the LM training main path at full width, 19. card vs CPU and
    # resume
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import make_optimizer
    L = SimpleNamespace(K=K, pf_mods=tuple(pf_mods.values()),
                        train=train_mod, models=models, api=api,
                        get_config=get_config, reduced=reduced,
                        flat_spec=flat_spec, tree_leaves=tree_leaves,
                        tree_map=tree_map, DataPlane=DataPlane,
                        SyntheticTokens=SyntheticTokens,
                        TrainEngine=TrainEngine, sgd_momentum=sgd_momentum,
                        make_optimizer=make_optimizer)
    gc.collect()
    torch.cuda.empty_cache()
    report["lm_train"], b1_store = lm_train_phase(L, rate)
    log(f"[{time.perf_counter() - t_start:.0f} s] LM training main path "
        "done")
    report["lm_parity"], lm_launches = lm_parity_phase(L)
    report["lm_resume"] = lm_resume_phase(L)
    log(f"[{time.perf_counter() - t_start:.0f} s] LM parity and resume "
        "done")
    lm_launches["dbl_apply_flat2d"] += \
        report["lm_train"]["launches"]["dbl_apply_flat2d"] + \
        report["lm_resume"]["launches"]
    for entry in line[:2]:
        n = lm_launches[entry["name"]]
        entry["launches"] += n
        entry["variants"][0]["launches"] += n           # "plain"
    # B1's line: the LM store, the shape this slice's main path gives it
    b1_store["launches"] = report["lm_train"]["launches"]["dbl_apply_flat2d"]
    line[0]["variants"].append(b1_store)
    line[0]["max_abs_err"] = max(line[0]["max_abs_err"],
                                 b1_store["max_abs_err"])
    line[0].update({k: b1_store[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")})

    # 20. the autotuner: B3's batched form against its plain version and
    # C B3 launches, the tuner's main path at full width, its batched
    # group against sequential replays, the width-8 search card vs CPU
    gc.collect()
    torch.cuda.empty_cache()
    batched_recs = batched_kernel_phase(K, rows, rate)
    report["tune"] = tune_phase(m, cfg)
    report["tune_parity"] = tune_parity_phase(m, small)
    log(f"[{time.perf_counter() - t_start:.0f} s] tuner done")
    tuned = report["tune"]["launches"]
    b3 = next(entry for entry in line if entry["name"] == WORKER)
    b3["variants"][0]["launches"] += tuned[WORKER]          # "plain"
    for r in batched_recs:
        r["launches"] = tuned[BATCHED] if r["variant"] == "batched" else 0
    b3["variants"].extend(batched_recs)
    b3["launches"] += tuned[WORKER] + tuned[BATCHED]
    b3["max_abs_err"] = max(r["max_abs_err"] for r in b3["variants"])
    report["kernels"] = line
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.0f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(nvidia_smi_line(), flush=True)
    # the per-variant records stay in the --out report: the line keeps
    # each kernel's main-path numbers (the whole line must fit the tail
    # of the output a caller reads)
    print(json.dumps({"kernels": [{k: v for k, v in r.items()
                                   if k != "variants"} for r in line]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
