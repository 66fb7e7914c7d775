#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]
    python3 chip_smoke.py --b5-times SRC    # B5's times alone, from SRC
    python3 chip_smoke.py --phases 1,28     # the build and the listed
                                            # phases that stand alone (23,
                                            # 25-28); the last line says
                                            # "phases": [1, 28]

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
    both also at every cluster size of ``CLUSTER_SIZES`` (checked at every
    shape, timed at the two full geometries), B5 with its position also
    as a 0-d int32 tensor on the card, bit-equal to the host int;
12. serving main path: ``ServeEngine(backend="paged")`` on
    ``phi3-mini-3.8b`` at full width (32 layers, bf16 params, f32 pages,
    weights from a seeded generator on the card) serving the 16 requests
    of ``SERVE_WORKLOAD``: one B6 launch per layer per decode tick and no
    plain attention at T = 1, tokens in the vocabulary, finite logits,
    the schedule ``run_serve_loop`` gives with stub hooks; tok/s, TTFT,
    TPOT, ms per decode tick, a profile of ``PROFILE_TICKS`` in the run
    that records the logits (B6's share, device idle share, top kernels;
    the copies of the logits to the host left out) and peak memory; the
    contiguous backend on the same requests (token agreement reported,
    not asserted: bf16 logits can tie); (a) the same requests sampled
    (``SAMPLE_KW``: T 0.8, top-k 40, seed 7, logits recorded): the greedy
    leg's schedule and B6 count, tokens in the vocabulary, the threefry
    keys of its (rid, step) pairs drawn on the card equal the CPU's bit
    for bit, the card's noise on the recorded logits gives the engine's
    tokens, and the CPU port's noise on them (drawn at each row's top-k
    columns alone, which a draw can pick; bit-equal to whole rows' on 8
    rows) picks the same tokens or lies within ``GUMBEL_CARD_BAND`` of
    them (near-ties and the smallest top-two gap printed); a second
    sampled run without recorded logits (the same tokens), its ms a tick
    against the timed greedy run's, the draw alone
    (``paged.sample_tokens`` at 8 rows) in device ms and launches;
13. serving parity: reduced gemma3-4b (two layers of window 16: the only
    card path that runs B6 with a window) and phi3-mini in f32 on the
    card against the CPU port on the churn workload, tokens identical and
    logits within ``SERVE_PARITY_BAND``; on the card, speculative decode
    (k = 3) and prefix sharing token-identical to one-token decode;
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
16. prefill parity: reduced f32 zamba2-2.7b (6 layers), rwkv6-7b and
    phi3-mini-3.8b (gemma3-4b in phase 28 (d)) on the card (B4 / B7 / B8)
    against the CPU port (the reference's scans), within
    ``PREFILL_PARITY_BAND``;
17. ``kernels/ops.py``: each front end once on the card, one launch of its
    kernel, against the plain version;
18. LM training main path: B1 (plain) at the flat-store shape of
    full-width ``phi3-mini-3.8b`` (29.85 M x 128 f32, past 2^31 elements)
    bit-equal to its plain version (run a slice at a time) and timed
    beside ``add_`` and its bytes bound; then ``launch.train.run`` on
    ``LM_ARGV`` (full width, bf16 params, block remat, hybrid dual-batch x
    CPL at seq 64 -> 128, fused SGD, 12 steps; logged every step rather
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
21. the static decode: (a) ``flash_decode`` (B5) on the models' ``(B, S,
    KV, hd)`` layer cache, read in place through its strides, at the
    static decode geometries of ``B5_SHAPES`` (phi3-mini hd 96, gemma3-4b
    hd 256 with its window, zamba2-2.7b's shared attention at hd 80), q
    and cache each in f32 and bf16, at positions 0, the middle and the
    last and every cluster size (``FD_F32_TOL``), the position also as a
    0-d int32 tensor on the card (bit-equal to the host int), and one
    launch captured in a CUDA graph replayed at the three positions
    written into its position tensor (bit-equal to eager launches);
    ``flash_attention`` (B4) with a query offset
    (offsets 0, 1, 17 and 512, chunks of 1, 5 and 64, with and without a
    window, f32 and bf16; ``PF_F32_TOL``), and on the layer cache's
    ``transpose(1, 2)`` views at a 0-d int32 offset on the card
    (``B4_CACHE_SHAPES``: a 64-token chunk at 512 and at the cache's
    last chunk, phi3-mini's cache and gemma3-4b's with and without its
    window), against its plain version and bit for bit against the
    host-int route over a copy of the first pos + 64 keys that it
    replaces; each timed beside its plain version, SDPA and its bound (B5
    also at every cluster size); (b)
    ``launch.serve.generate`` at full width in bf16, every call at a
    position kept on the card: phi3-mini-3.8b on 4 x 512 prompt
    tokens + 64 generated (``max_seq`` 576) with exactly 32 B4 launches
    (the chunked prefill) and 32 x 63 B5 (one a layer a decode step), no
    plain attention; ms of
    the prefill and a decode step (CUDA events around each decode call),
    tokens/s, peak memory and one profiled decode step (idle share, B5's
    share, top kernels); zamba2-2.7b (9 B5 launches a step) and rwkv6-7b
    (no kernel) on 4 x 32 + 32, ms a step; and phi3 sampled,
    ``generate(greedy=False, rng=PRNGKey(0))`` on the same prompts: the
    same launches, bf16 logits, the keys and the bf16 noise (all 128
    values of its uniform) card = CPU bit for bit, the CPU's draw on the
    card's logits the card's tokens exactly, ms a step against greedy;
    (c) reduced f32 phi3-mini,
    zamba2-2.7b (6 layers) and rwkv6-7b (gemma3-4b in phase 28 (d)),
    ``generate`` on the card against the CPU port: identical greedy tokens,
    logits within ``DECODE_PARITY_BAND``, the stepped prefill against the
    chunked one; the static path's tokens against ``ServeEngine(backend=
    "paged")`` over ``PAGED_DRAWS`` prompt draws, reported; and sampled,
    reduced phi3-mini's paged engine (``PARITY_SAMPLE_KW``) and
    ``generate`` (``PRNGKey(5)``) on the card and the CPU: the same
    tokens.
22. the MoE family, ``granite-moe-3b-a800m`` (40 experts, top-8, GQA 24 /
    8 heads of 64, n_rep 3): (a) its kernel geometries ride in phases 11,
    14 and 21 (rows of ``FD_SHAPES``, ``FA_SHAPES`` and ``B5_SHAPES``: B5
    and B6 serve 3 heads from their kRep = 4 form); at full width in bf16
    (weights from a seeded generator on the card) (b) the prefill (2 x
    2048, 32 B4 launches) with the MoE layer's device time split into
    router, routing, dispatch / combine einsums and expert einsums
    (``record_function`` ranges under ``torch.profiler``), (c) the static
    decode (4 x 512 + 64: 32 B4 and 32 x 63 B5 launches), (d) the paged
    engine on phase 12's requests at 8 of 32 layers (8 B6 launches a
    tick), (e) LM training through the CLI (``GRANITE_TRAIN_ARGV``, phase
    18's cut to 4 steps: one B1 launch a step at granite's store, finite
    loss, aux > 0), each path
    with phase 15 / 21 / 12 / 18's records; (f) reduced f32 granite (6 / 2
    heads of 64) on the card against the CPU port: prefill, ``generate``,
    the paged engine and 4 training steps within phases 16 / 21 / 13 /
    19's bands, each CPU leg on the card's expert choices (``RouteSides``)
    after the free CPU run's choices differed at most at near-ties
    (``ROUTE_TIE``); a planted fault (token-major capacity queues) outside
    the prefill band.
23. multi-GPU SPMD on one NCCL rank (the card host has one H100), mesh
    ``(1, 1)`` named ``("data", "model")``: (a) B2's leafwise form
    (``ops.dbl_merge(leafwise=True)``) on a full-width phi3-mini-3.8b
    tree of DTensors (views of one seeded N(0, 1) f32 store): one launch
    per leaf, bit-equal to the flat one-launch form and to the plain
    version, timed (the sum over leaves) beside both and the bytes bound;
    (b) the main path, ``SpmdBackend(TrainEngine(cfg, sgd, mesh=mesh,
    fused_merge=True), plane)`` at full width and depth in f32 on the
    example's plan and phase (``examples/dual_batch_spmd.py``: seq 64,
    global batch 16, lr 0.01, 10 steps): one B2 launch per leaf per step
    and nothing else, finite losses, the last below the first, params
    DTensors on the card; ms a step, tokens/s, peak memory, a profiled
    step (idle share, B2's share); (c) mesh against no mesh at full
    width and ``SPMD_CUT_LAYERS`` layers, the fused form (no mesh: the
    per-step loop) over 10 steps and the example's own weighted form
    (``sgd_momentum(0.9)``) over 4: params bit for bit equal, ms a step
    both ways; (d) reduced f32 phi3-mini, 4 fused steps on the card
    against the CPU port on a 4-rank gloo ``(2, 2)`` mesh that the phase
    spawns, within ``TRAIN_PARITY_BAND``, and a planted fault (per-rank
    denominators in the weighted loss) outside it.
24. the encoder-decoder family, ``seamless-m4t-large-v2`` (24 encoder and
    24 decoder layers, 16 / 16 heads of 64, vocab 256,206; its kernel
    geometries ride in phases 14 and 21: B4 non-causal over 4096 keys at
    4096, 512 and one query, B5 at n_rep 1, hd 64, the one-query row also
    timed against B5 on the same keys and beside the k / v copies B4's
    route makes) at full width in bf16 (weights from a seeded generator on
    the card, frames N(0, 1)): (a) ``make_prefill_step(cfg)(params,
    tokens, frames)`` on 2 x (4096 frames + 512 tokens): exactly 72 B4
    launches (24 encoder, 24 causal decoder, 24 cross-attention) and
    nothing else, finite (2, vocab) logits; ms a prefill, frames + tokens
    a second, a profile and peak memory; (b) the serving example's static
    decode: 4 x 4096 frames encoded once (24 B4), then
    ``make_decode_step`` one-token steps at an int32 position on the card
    advanced in place, a 32-token prompt stepped and 96 greedy tokens
    (max_seq 128): exactly 24 B5 and 24 B4 (the cross-attention at one
    query) a step over 127 steps and nothing else; ms a step (CUDA events
    around each call), tokens/s, peak memory and one profiled step (idle
    share, B4 and B5 shares, the copy kernels); (c) 4 steps of
    ``launch.steps.make_train_step(cfg, sgd_momentum(0.9))`` on 2 x (4096
    frames + 256 tokens): no B4 / B5 launch (the training forward runs the
    scans), finite losses, params changed; ms a step and peak memory; (d)
    reduced f32 seamless (2 + 2 layers, 4 / 4 heads of 64, 64 frames) on
    the card against the CPU port: prefill logits within
    ``PREFILL_PARITY_BAND`` and a planted causal encoder outside it, the
    encode + stepped decode with identical greedy tokens and logits within
    ``DECODE_PARITY_BAND``, one train step within ``TRAIN_PARITY_BAND``.
25. the remaining configs and the input shapes (``configs/shapes.py``,
    ``launch/specs.py``): (a) ``abstract_params`` of the ten LM configs at
    full depth and ``input_specs`` of every (config, shape) pair on the
    meta device, the card's allocated bytes unchanged; then llama3-405b,
    deepseek-67b, arctic-480b and chameleon-34b (hd 128 at n_rep 16, 8, 7
    and 8; their kernel geometries ride in phases 11, 14 and 21) at full
    width in bf16 on seeded weights drawn on the card, ``BIG_LAYERS`` deep
    (2, 2, 1, 2) so that the params and decode_32k's cache fit the card:
    (b) ``make_prefill_step(cfg)`` at prefill_32k's 32,768 tokens (batch
    cut to 1): one B4 launch a layer and nothing else, finite logits; ms a
    prefill, tokens/s, peak memory, a profile (arctic: the MoE layer's
    split); and B4 at that geometry (1 x 32,768, causal, bf16) against its
    plain version, run 1,024 queries of one KV head's query heads at a
    time (``PF_F32_TOL`` plus one bf16 ulp), timed beside its bound and
    SDPA; (c) ``make_decode_step(cfg, SHAPES["decode_32k"])`` over
    ``init_cache(cfg, 128, 32768)`` filled with N(0, 1) bf16 draws: 8
    one-token steps from a device pos of 32,759, one B5 launch a layer a
    step and nothing else; ms a step, and B5 on that cache against its
    plain version (a row at a time), timed beside its bytes bound and SDPA;
    (d) the same at long_500k (1 x 524,288, the window override: every
    layer a window of 8,192), and a planted check: every key and value
    before the window rewritten, the step's logits bit-equal; without the
    shape they differ; (e) the reduced f32 four (n_rep kept at hd 128,
    ``BIG_REDUCED``) on the card against the CPU port: prefill within
    ``PREFILL_PARITY_BAND``, ``generate`` tokens identical and logits
    within ``DECODE_PARITY_BAND``, a long_500k-named shape of 64 positions
    at window 16 through ``make_decode_step(cfg, shape)`` within
    ``DECODE_PARITY_BAND``, and (not chameleon) phase 13's churn workload
    through the paged engine, tokens and schedule identical and logits
    within ``SERVE_PARITY_BAND`` (arctic's CPU legs on the card's expert
    choices); (f) llama3-405b, deepseek-67b and arctic-480b (not
    chameleon-34b: deepseek's n_rep and hd) through the paged engine on
    (b)-(d)'s params, phase 12's requests on bf16 pages: first B6 at the
    first full tick's geometry (its page table and lengths, 8 rows, bf16
    q and pages) against its plain version within phase 11's tolerance
    plus one bf16 ulp at every cluster size, timed beside its bound and
    gather + SDPA; then a greedy run (logits recorded, 10 full ticks
    profiled), a timed greedy run with the same tokens and the sampled
    leg of phase 12 (a); one B6 launch (its kRep-8 form) a layer a decode
    tick and no plain run.
26. the dry run and cost analysis (``launch/dryrun.py``,
    ``launch/hlo_analysis.py``): (a) ``python -m
    repro_torch.launch.dryrun --arch granite-moe-3b-a800m --shape
    decode_32k --both-meshes`` in a subprocess (the reference test's
    pair, on fake process groups of 256 and 512 ranks over the card's
    mesh; its records written to a temporary directory and read back):
    exit 0 and "all dry-runs passed", each record's per-rank FLOPs,
    collective bytes by kind and dominant term printed; (b) phase 15's
    full-width zamba2-2.7b prefill (2 x 2048) counted twice, on meta
    tensors (B4 and B7 by the formulas beside their wrappers, 9 and 45
    meta launches) and on the card (9 B4 and 45 B7 launched and counted
    by the same formulas): equal FLOPs and ``dot_bytes_flash``, finite
    logits; the median CUDA-event ms of 3 prefills beside the roofline's
    ``step_time_s`` on one card and their ratio (printed, not gated);
    (c) ``engine.parity.check_parity`` on the card (reduced phi3-mini,
    its bit-for-bit checks in PyTorch's deterministic mode).
27. rwkv6-7b LM training at 4,096 tokens: (a) one full-width layer's
    training forward at 4,096 tokens with the chunked WKV scan, its
    one-level form (one block a chunk) and the per-token form
    (``ref.wkv6_ref``): the bytes autograd keeps for the backward (one
    state a chunk against three a token), the scans' f32 outputs within
    ``WKV_FORMS_BAND``; the chunked forms' forward and backward times
    and peaks, their grads finite; (b) phase 18's path on
    ``RWKV_TRAIN_ARGV`` (hybrid 2048 -> 4096, global batch 4, fused SGD)
    at full width and ``RWKV_TRAIN_LAYERS`` of 32 layers: B1 at that
    store's shape against its plain version, then one B1 launch a step
    and no B4 / B7 / B8, finite losses, peak memory under 80 GB; ms and
    tokens/s a step, one profiled step at 4,096 (idle share, kernels,
    B1's share); (c) reduced f32 rwkv6 at seq 256 (four chunks), fused,
    card vs CPU within ``TRAIN_PARITY_BAND``.
28. gemma3-4b at full width (34 layers in one attention segment: window
    1,024 but on the global layers 5, 11, 17, 23 and 29; 8 / 4 heads of
    256), bf16: first B4 and B5 at the path's own geometry against their
    plain versions (``PF_F32_TOL`` / ``FD_F32_TOL`` plus one bf16 ulp),
    window 1,024 and global, each timed beside its bound, its plain
    version and SDPA: B4 on (a)'s 2 x 2048 and on (b)'s 1,984-token chunk
    at a device offset of 0 over the 2,048-key cache views, B5 at (b)'s
    positions 1,984, 2,016 and 2,046 on the card; then one draw of
    weights on the card for (a) phase 15's prefill on 2 x 2048 tokens (34
    B4 launches a forward, no plain attention, finite (2, vocab) logits,
    ms, tokens/s, peak memory and a profile), (b) phase 21 (b)'s
    ``generate`` on 4 x 1,984 + 64 (max_seq 2,048; 34 B4 in the chunked
    prefill and 34 x 63 B5, ``pos`` on the card; ms of the prefill and a
    step, a profiled step) and (c) phase 12's greedy paged legs on 8
    requests of 1,100-1,400 prompt tokens and 32 new (bf16 pages of 16, 8
    slots x 96 pages, chunks of 128): every layer through the plain route
    (``paged._slot_attention``) at its own window in every prefill call
    and decode tick, no B6, the schedule of ``run_serve_loop`` with stub
    hooks, tok/s, TTFT, TPOT, the plain route's share of profiled ticks,
    and token agreement with (b)'s path on the same prompts (reported);
    (d) reduced f32 gemma3 at 6 layers (five local of window 16, the
    global one) on the card against the CPU port through phases 16, 21
    (c) and 13's legs: prefill within ``PREFILL_PARITY_BAND``,
    ``generate`` on a prompt longer than the window with identical tokens
    and logits within ``DECODE_PARITY_BAND``, the paged engine on the
    churn workload (the mixed segment's plain route, no B6) with
    identical tokens and logits within ``SERVE_PARITY_BAND``.

The launch counts are set to 0 just before each path and read just
after; the ``launches`` in the kernels line are those counts, summed
over the main path and the short runs (for B1 and B2, the engine runs of
phases 3-4 and the LM runs of phases 18-19 on the card; for B5 and B6,
the paged serving main path's timed run and its two sampled runs (12 (a)),
and for B5 the static decode runs of phase 21 (b), greedy and sampled,
on phi3-mini and zamba2-2.7b — the only path that calls B5, whose
numbers in the line are its phi3 static decode form; for B4, B7 and B8,
one forward of each model of phase 15, B4 adding phase 21's chunked
prefills (greedy and sampled); B3 adds phase 20's search, its one-store
and batched launches, the batched form's records among its variants;
phase 22 adds granite's B4, B5, B6 and B1 launches on its four paths and
its card-vs-CPU training steps, B1's granite-store record among its
variants; phase 23 adds B2's leafwise launches of its mesh runs on the
card, (b), (c) and (d), and B2's numbers in the line are its leafwise
form at the phi3 tree, the form this slice's main path runs; phase 24
adds seamless's B4 and B5 launches of its full-width prefill (a) and
static decode (b), the encode included; phase 25 adds the B4 launches of
its four prefills (b) and the B5 launches of its decode_32k and
long_500k steps (c, d), B4's rows at 32,768 tokens and B5's at those
caches among their variants; phase 26 adds the B4 and B7 launches of
its counted and timed zamba2 prefills (b) and the B1, B2 and B3
launches of the parity module on the card (c); phase 27 adds the B1
launches of its training run and its card-vs-CPU steps, B1's
rwkv6-store record among its variants; phase 28 adds gemma3's B4
launches of (a) and (b) and its B5 launches of (b), the rows at its
path's geometry among their variants). Launches made to compare a kernel with its
plain version are not counted. B1's numbers in the line are its LM-store
ones (phase 18), the shape this slice's main path gives it; the
ResNet-store records stay among its variants.
The last three lines of standard output are the card's name and power
limit (as ``nvidia-smi`` gives them), one JSON object with the kernels'
numbers, and ``{"ok": true, "device": {...}}``.

``--b5-times SRC`` runs none of that: it imports the port from SRC (for
instance a parent commit's ``src``, unpacked by ``git archive``), builds
its ``flash_decode.cu``, times B5 at the timed forms of phases 11 and
21 (a) (``b5_times``) and prints the nvidia-smi line and one JSON line of
records.  Alternating two trees in one call (parent, change, change,
parent) compares them on one card and host.
"""
import argparse
import contextlib
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
# reduced shapes of tests/test_torch_serve.py; then granite-moe-3b-a800m
# (phase 22 (a): n_rep 3, hd 64, full and reduced heads); then the heads
# of llama3-405b, deepseek-67b and arctic-480b (phase 25: hd 128 at n_rep
# 16, 8 and 7 — B5 / B6 serve 8 query heads a block: two groups a KV
# head, one, and one of 7 in 8), at 1023 keys.  Each row of a
# table gets its own pages (a permutation of the pool); row 1 is dead
# (every entry the sentinel id n_pages, length 0).
GRANITE = "granite-moe-3b-a800m"
SEAMLESS = "seamless-m4t-large-v2"
FD_SHAPES = (("phi3-mini-3.8b", 8, 32, 32, 96, 16, 64, 512, 1023, (0, 64)),
             ("gemma3-4b", 8, 8, 4, 256, 16, 128, 1024, 2047, (1024,)),
             ("gemma3-4b-reduced", 2, 4, 2, 64, 16, 4, 8, 63, (16,)),
             ("phi3-mini-3.8b-reduced", 2, 4, 4, 64, 16, 4, 8, 63, (0,)),
             (GRANITE, 8, 24, 8, 64, 16, 64, 512, 1023, (0,)),
             (f"{GRANITE}-reduced", 2, 6, 2, 64, 16, 4, 8, 63, (0,)),
             ("llama3-405b", 8, 128, 8, 128, 16, 64, 512, 1023, (0,)),
             ("deepseek-67b", 8, 64, 8, 128, 16, 64, 512, 1023, (0,)),
             ("arctic-480b", 8, 56, 8, 128, 16, 64, 512, 1023, (0, 64)))
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
# the range the serve runs put around the step's plain attention route
# (``paged._slot_attention``), whose device time the profiled ticks read
SLOT_RANGE = "slot_attention"
# phase 12 (a), the sampled leg: phase 12's requests at the serving
# example's settings (T 0.8, top-k 40, sample seed 7), logits recorded
SAMPLE_KW = dict(temperature=0.8, top_k=40, sample_seed=7)
# f32 Gumbel noise, card against CPU: CUDA's logf and the CPU's log each
# lie within an ulp of the rounded result, so ``-log(-log(u))`` differs by
# up to 2 ulp of g (low-mode noise: |g| < 16, an ulp at most 2**-20) plus
# the inner log's rounding carried through (2**-22 absolute); a draw the
# two devices' noise picks differently has its top-two gap of
# ``lo / T + g`` within twice that plus an ulp of z (the sum's rounding)
GUMBEL_CARD_BAND = 2 * 2.0 ** -20 + 2.0 ** -22
REDRAW_ROWS = 64                 # rows of the card's noise drawn at a time
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
                        else:
                            rec.update(_b5_splits(
                                FD, q, kc, vc, pos, w, r5, label,
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
                    log(f"    {name} q {r['q']} cache "
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


def _b5_splits(FD, q, kc, vc, pos, w, ref, label, timed):
    """B5 at every cluster size, each against the plain version ``ref``
    (within the phase's tolerance), and with ``pos`` as a 0-d int32
    tensor on the card bit-equal to the host int at each; where
    ``timed``, each size timed (events and device time).  Returns the
    size the wrapper chooses itself, and the times."""
    rows, h, _, hd = q.shape
    kvh, s = kc.shape[1], kc.shape[2]
    rec = {"split": FD.decode_cluster_size(
        rows, h, kvh, s,
        torch.cuda.get_device_properties(0).multi_processor_count, hd,
        kc.element_size(), w)}
    dev_pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    times, dev = {}, {}
    for c in FD.CLUSTER_SIZES:
        call = lambda: FD.flash_decode(q, kc, vc, pos, window=w, split=c)
        out = call()
        on_card = FD.flash_decode(q, kc, vc, dev_pos, window=w, split=c)
        torch.cuda.synchronize()
        err, ok, worst = _fd_err(out, ref)
        if not ok:
            raise AssertionError(
                f"flash_decode {label} pos {pos} window {w} cluster {c}: "
                f"kernel differs from its plain version by {err}; worst "
                f"{worst}")
        if not torch.equal(on_card, out):
            raise AssertionError(
                f"flash_decode {label} pos {pos} window {w} cluster {c}: "
                "the device pos gives other bits than the host int")
        if timed:
            times[c] = cuda_ms(call)
            dev[c] = device_ms(call)
    if timed:
        rec.update(split_ms=times, split_device_ms=dev)
    return rec


def _b5_replay(FD, q, kc, vc, w, positions, label):
    """One B5 launch captured in a CUDA graph with its position in a 0-d
    int32 tensor on the card, replayed at each of ``positions`` written
    into that tensor: bit-equal to an eager launch at the host int."""
    pos = torch.zeros((), dtype=torch.int32, device="cuda")
    FD.flash_decode(q, kc, vc, pos, window=w)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = FD.flash_decode(q, kc, vc, pos, window=w)
    for p in positions:
        pos.fill_(p)
        graph.replay()
        want = FD.flash_decode(q, kc, vc, p, window=w)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(
                f"flash_decode {label}: the captured launch replayed at "
                f"pos {p} differs from an eager launch")
    del graph


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
    ``torch.profiler`` window (prefill calls between them stay outside)
    and the device time of the kernels launched under ``SLOT_RANGE``.
    Returns the record dict the wrapper fills."""
    from torch.profiler import ProfilerActivity, profile
    inner = engine.decode
    rec = {"tick_s": [], "rows": [], "profiled": []}

    def decode(slots):
        i = len(rec["tick_s"])
        prof = None
        if profile_ticks and i in profile_ticks:
            # host activity too, for the range's device time: the profiled
            # ticks' wall time is not the timed run's
            prof = profile(activities=[ProfilerActivity.CUDA,
                                       ProfilerActivity.CPU])
            prof.__enter__()
        t0 = time.perf_counter()
        out = inner(slots)
        wall = time.perf_counter() - t0
        rec["tick_s"].append(wall)
        rec["rows"].append(len(slots))
        if prof is not None:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            # device work only: a recorded run's logits copied to the host
            # (and the tick's tokens) are not counted
            kern, in_range = {}, 0.0
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    # the range's own device-side span is no kernel
                    if not ev.name.startswith("Memcpy DtoH") and \
                            ev.name != SLOT_RANGE:
                        kern[ev.name] = kern.get(ev.name, 0.0) + \
                            ev.time_range.elapsed_us()
                elif ev.name == SLOT_RANGE:
                    dev = getattr(ev, "device_time_total", None)
                    in_range += ev.cuda_time_total if dev is None else dev
            rec["profiled"].append({"rows": len(slots), "wall_s": wall,
                                    "kernels_us": kern,
                                    "slot_attention_us": in_range})
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
    slot = sum(t["slot_attention_us"] for t in profiled)
    return {"ticks": n, "rows": [t["rows"] for t in profiled],
            "slot_attention_ms_per_tick": slot / 1e3 / n,
            "slot_attention_share_of_device": slot / busy if busy else 0.0,
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


@contextlib.contextmanager
def _plain_route(S):
    """Count the serve step's calls of its plain attention route
    (``paged._slot_attention``) by window, each under ``SLOT_RANGE`` for
    a profiler; yields the counts."""
    route, inner = {}, S.paged._slot_attention

    def slot_attention(q, k, v, positions, window):
        route[window] = route.get(window, 0) + 1
        with torch.profiler.record_function(SLOT_RANGE):
            return inner(q, k, v, positions, window)
    S.paged._slot_attention = slot_attention
    try:
        yield route
    finally:
        S.paged._slot_attention = inner


def serve_run(S, cfg, params, reqs, spec, *, backend="paged", record=False,
              profile_ticks=None, sample=None, chunk=SERVE_CHUNK):
    """One ``ServeEngine.serve`` on the card with the launch counts set to
    0 just before it (``sample``: the engine's sampling arguments);
    returns what the run shows, with the windows of the step's calls of
    the plain attention route (``paged._slot_attention``, under
    ``SLOT_RANGE``; ``route``: calls by window)."""
    engine = S.ServeEngine(cfg, params, spec=spec,
                           backend=backend, prefill_chunk=chunk,
                           record_logits=record, **(sample or {}))
    ticks = _timed_decode(engine, profile_ticks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    S.FD.reset_counts()
    with _plain_route(S) as route:
        t0 = time.perf_counter()
        recs = engine.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {"recs": recs, "wall_s": wall, "log": engine.log, "route": route,
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


SERVE_LEGS = ("paged_recorded", "paged", "paged_sampled",
              "paged_sampled_timed", "contig")


def _want_route(S, cfg, stats, paged=True):
    """The step's calls of the plain attention route by window over a
    serve run: every layer at its own window in each prefill call, and in
    each decode tick too, but for the layers of a uniform-window segment
    on the paged backend (B6 on the card); and the B6 launches a tick."""
    segs = S.paged.attention_segments(cfg)
    route = {}
    for seg in segs:
        uniform = paged and len(set(seg.windows)) == 1
        calls = stats["prefill_calls"] + (0 if uniform
                                          else stats["decode_calls"])
        for w in seg.windows:
            route[w] = route.get(w, 0) + calls
    b6 = sum(seg.count for seg in segs if len(set(seg.windows)) == 1)
    return {w: n for w, n in route.items() if n}, b6 if paged else 0


def serving_phase(S, arch=SERVE_ARCH, legs=SERVE_LEGS, *, cfg=None,
                  params=None, store=torch.float32, reqs=None, spec=None,
                  chunk=SERVE_CHUNK):
    """Phase 12: the paged ServeEngine at the full width of phi3-mini
    (all 32 layers, bf16 params and compute, f32 pages), B6 in every layer
    of every decode tick; (a) the same requests sampled (``SAMPLE_KW``,
    ``sampled_leg``); then the contiguous backend on the same requests
    (phase 22 (d): ``arch`` granite, the greedy paged legs only, ``cfg``
    cut in depth; phase 25 (f): the wide-GQA configs at cut depth on the
    ``params`` phase 25 drew, bf16 pages; phase 28 (c): gemma3-4b's
    ``reqs`` on its ``spec`` in prefill chunks of ``chunk``, its mixed
    segment through the plain route, no B6)."""
    import numpy as np
    if params is None:
        cfg = cfg or S.get_config(arch)
        params = S.models.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
    n_params = sum(t.numel() for t in S.tree_leaves(params))
    if reqs is None:
        reqs = S.synthetic_workload(0, SERVE_REQUESTS, vocab=cfg.vocab_size,
                                    **SERVE_WORKLOAD)
    spec = spec or S.PageSpec(**SERVE_SPEC, store_dtype=store)
    want_log = S.run_serve_loop(reqs, spec, _StubHooks(),
                                prefill_chunk=chunk)
    n_layers = cfg.n_layers
    runs = {}
    # the recorded run comes first and warms the card up (cuBLAS handles
    # and heuristics), and runs the first PROFILE_TICKS decode ticks with
    # the most slots busy (every slot, but for phase 28 (c)'s long
    # prompts, one prefill chunk a tick) under torch.profiler (a run of
    # its own until phase 25 needed the time); the timed run has nothing
    # else in it
    ticks_rows = [len(e[2]) for e in want_log if e[0] == "decode"]
    most = max(ticks_rows)
    full = [i for i, m in enumerate(ticks_rows) if m == most][:PROFILE_TICKS]
    for leg, kw in (("paged_recorded", {"record": True,
                                        "profile_ticks": set(full)}),
                    ("paged", {}),
                    ("paged_sampled", {"record": True, "sample": SAMPLE_KW}),
                    ("paged_sampled_timed", {"sample": SAMPLE_KW}),
                    ("contig", {"backend": "contig", "record": True})):
        if leg not in legs:
            continue
        r = serve_run(S, cfg, params, reqs, spec, chunk=chunk, **kw)
        calls = r["stats"]["decode_calls"]
        if r["log"] != want_log:
            raise AssertionError(f"{leg}: the engine's schedule differs from "
                                 "run_serve_loop's with stub hooks")
        route, b6_layers = _want_route(
            S, cfg, r["stats"], kw.get("backend", "paged") == "paged")
        want_b6 = b6_layers * calls
        if r["b6"] != want_b6 or r["plain"] or r["route"] != route or \
                r["launches"]["flash_decode"]["f32"] + \
                r["launches"]["flash_decode"]["bf16"]:
            raise AssertionError(f"{leg}: launches {r['launches']}, plain "
                                 f"runs {r['plain']}, plain-route calls by "
                                 f"window {r['route']}: expected {want_b6} "
                                 "flash_decode_paged launches "
                                 f"({b6_layers} layers x {calls} decode "
                                 f"calls), plain-route calls {route} and "
                                 "nothing else")
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
    prof = _profile_share(runs["paged_recorded"]["ticks"]["profiled"],
                          ticks)
    out = {"arch": arch, "params": n_params,
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
           "prefill_chunk": chunk, "b6_launches": main["b6"],
           "slot_attention_calls": main["route"],
           "tokens": {x.rid: list(x.tokens) for x in recs},
           "profile": prof,
           "peak_bytes": main["peak"],
           "compile_log": [list(k) for k in main["compile_log"]]}
    repeat = [ra.tokens == rb.tokens for ra, rb in
              zip(recs, runs["paged_recorded"]["recs"])]
    out.update(paged_repeats_itself=all(repeat))
    if "contig" in runs:
        agree = [a == b for ra, rc in zip(runs["paged_recorded"]["recs"],
                                          runs["contig"]["recs"])
                 for a, b in zip(ra.tokens, rc.tokens)]
        out.update(contig_wall_s=runs["contig"]["wall_s"],
                   contig_tok_per_s=n_tok / runs["contig"]["wall_s"],
                   paged_contig_token_agreement=sum(agree) / len(agree))
    log(f"serving main path: {arch} full width, {n_layers} layers "
        f"({n_params / 1e9:.2f} B params, bf16; "
        f"{str(spec.store_dtype)[6:]} pages, "
        f"{spec.pool_bytes(cfg) / 2**20:.1f} MiB), {len(reqs)} requests, "
        f"{n_tok} tokens in "
        f"{out['wall_s']:.2f} s: {out['tok_per_s']:.1f} tok/s, mean TTFT "
        f"{out['mean_ttft_s'] * 1e3:.1f} ms, mean TPOT "
        f"{out['mean_tpot_s'] * 1e3:.2f} ms; {out['decode_calls']} decode "
        f"ticks ({out['ms_per_decode_tick']:.2f} ms each, "
        f"{out['ms_per_decode_tick_8_rows']:.2f} ms at 8 rows), "
        f"{out['prefill_calls']} prefill calls; {main['b6']} B6 launches, "
        f"plain-route calls by window {main['route']}; peak "
        f"{main['peak'] / 2**30:.2f} GiB")
    log(f"  profiled decode ticks {full} (rows {prof['rows']}): "
        f"{prof['ms_per_tick']:.2f} ms/tick under the "
        f"profiler, {prof['unprofiled_ms_per_tick']:.2f} ms in the timed run; "
        f"device busy {prof['device_busy_ms_per_tick']:.2f} ms/tick (idle "
        f"{prof['device_idle_share_unprofiled']:.0%} of the timed tick), B6 "
        f"{prof['b6_ms_per_tick']:.3f} ms/tick "
        f"({prof['b6_share_of_tick']:.1%} of the tick, "
        f"{prof['b6_share_of_device']:.1%} of device time), the plain "
        f"route ({SLOT_RANGE}) {prof['slot_attention_ms_per_tick']:.3f} "
        f"ms/tick ({prof['slot_attention_share_of_device']:.1%} of device "
        "time)")
    for k in prof["top_kernels"]:
        log(f"    {k['ms_per_tick']:7.3f} ms/tick {k['share']:6.1%}  "
            f"{k['name']}")
    if "contig" in runs:
        log(f"  contiguous backend (plain attention) on the same requests: "
            f"{out['contig_tok_per_s']:.1f} tok/s; tokens agreeing with "
            f"the paged run {out['paged_contig_token_agreement']:.1%}")
    log(f"  paged run repeats itself: {out['paged_repeats_itself']}")
    path = {k: dict(v) for k, v in main["launches"].items()}
    if "paged_sampled" in runs:
        out["sampled"] = sampled_leg(S, cfg, runs)
        for leg in ("paged_sampled", "paged_sampled_timed"):
            for k, v in runs.get(leg, {"launches": {}})["launches"].items():
                for var, n in v.items():
                    path[k][var] += n
    del runs, params, main
    torch.cuda.empty_cache()
    return out, path


def _kept_noise(S, keys, cols):
    """f32 Gumbel noise of each key (N, 2) at its row's columns ``cols``
    (N, k) alone, op for op as ``prng.gumbel`` draws whole rows: the
    partitionable threefry counts a row's draws by column, so column j's
    bits are those of counter (0, j); then ``prng.uniform``'s f32 form on
    [tiny, 1) and ``-log(-log(u))``."""
    x = cols.to(torch.int64)
    b1, b2 = S.prng.threefry2x32(keys[:, :1], keys[:, 1:],
                                 torch.zeros_like(x), x)
    floats = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - torch.ones((), dtype=torch.float32)
    lo = torch.full((), torch.finfo(torch.float32).tiny)
    hi = torch.full((), 1.0)
    u = torch.maximum(lo, floats * (hi - lo) + lo)
    return u.log().neg().log().neg()


def sampled_leg(S, cfg, runs):
    """Phase 12 (a): the paged engine's sampled run (``SAMPLE_KW``, logits
    recorded) against the greedy legs and the CPU port.  Its schedule and
    B6 count are the greedy run's (checked with the other legs); every
    token is in the vocabulary.  The keys of its (rid, step) pairs drawn on
    the card equal the CPU's bit for bit; the card's noise on the recorded
    logits reproduces the engine's tokens; the CPU's noise (at each row's
    top-k columns, ``_kept_noise``) picks the same tokens, or the two picks
    lie within the Gumbel band of each other (``GUMBEL_CARD_BAND``;
    near-ties counted, the smallest top-two gap reported).  Times: ms a
    tick of a second sampled run that records no logits (its tokens the
    recorded run's; phase 25 (f) has none and reads the recorded run's)
    against the timed greedy run, which records none either; the draw
    alone (``paged.sample_tokens`` at 8 rows) in device ms and the
    launches it adds."""
    import numpy as np
    r, greedy = runs["paged_sampled"], runs["paged"]
    timed = runs.get("paged_sampled_timed", r)
    if r["b6"] != greedy["b6"] or timed["b6"] != greedy["b6"]:
        raise AssertionError(f"sampled leg: {r['b6']} / {timed['b6']} B6 "
                             f"launches, the greedy leg {greedy['b6']}")
    if [x.tokens for x in timed["recs"]] != [x.tokens for x in r["recs"]]:
        raise AssertionError("sampled leg: the run without recorded logits "
                             "gives other tokens than the recorded run")
    pairs = [(rec.rid, s) for rec in r["recs"] for s in range(len(rec.tokens))]
    want = torch.tensor([t for rec in r["recs"] for t in rec.tokens])
    lo = torch.from_numpy(np.stack([lg for rec in r["recs"]
                                    for lg in rec.logits]))
    rids, steps = (torch.tensor(c, dtype=torch.int32) for c in zip(*pairs))
    seed, temp, top_k = (SAMPLE_KW[k] for k in ("sample_seed", "temperature",
                                                "top_k"))
    derive = lambda dev: S.prng.fold_in(S.prng.fold_in(
        S.prng.PRNGKey(seed, dev), rids.to(dev)), steps.to(dev))
    keys, keys_card = derive("cpu"), derive("cuda")
    if not torch.equal(keys_card.cpu(), keys):
        raise AssertionError("sampled leg: the keys drawn on the card differ "
                             "from the CPU's")
    scale = torch.ones(()) / torch.tensor(temp)
    kth = torch.topk(lo, top_k, dim=-1).values[..., -1:]
    # a draw picks a kept column (the others sit at NEG_INF / T, far below
    # any noise), so the noise is compared there alone: each row's kept
    # columns in order, padded with its first at NEG_INF
    v = lo.shape[1]
    kept = lo >= kth
    cols = torch.sort(torch.where(kept, torch.arange(v), v), dim=-1).values
    cols = cols[:, :int(kept.sum(-1).max())]
    pad = cols == v
    cols = torch.where(pad, cols[:, :1], cols)
    cut = torch.where(pad, S.paged.NEG_INF, lo.gather(1, cols)) * scale
    g = _kept_noise(S, keys, cols)
    g_card = torch.cat([
        S.prng.gumbel(keys_card[i:i + REDRAW_ROWS], (v,)).gather(
            1, cols[i:i + REDRAW_ROWS].cuda()).cpu()
        for i in range(0, len(pairs), REDRAW_ROWS)])
    if not torch.equal(S.prng.gumbel(keys[:8], (v,)).gather(1, cols[:8]),
                       g[:8]):
        raise AssertionError("sampled leg: the CPU's noise at the kept "
                             "columns differs from its whole rows' there")
    z = cut + g
    at = lambda j: cols.gather(1, j[:, None])[:, 0]
    picks = at(z.argmax(-1))
    if not torch.equal(at((cut + g_card).argmax(-1)), want):
        raise AssertionError("sampled leg: the card's noise on the recorded "
                             "logits does not give the engine's tokens")
    dg = (g_card.double() - g.double()).abs()
    ulp_g = torch.from_numpy(np.spacing(np.abs(g.numpy()))).double()
    if not bool((dg <= 2 * ulp_g + 2.0 ** -22).all()):
        raise AssertionError(f"sampled leg: f32 noise card vs CPU "
                             f"{float(dg.max()):.3g} beyond 2 ulp + 2**-22")
    top2 = z.topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).double()
    near, worst = 0, 0.0
    for i in torch.nonzero(picks != want).flatten().tolist():
        zi = dict(zip(cols[i].tolist(), z[i].tolist()))
        gap = zi[int(picks[i])] - zi[int(want[i])]
        band = 2 * (GUMBEL_CARD_BAND + float(np.spacing(np.float32(
            abs(zi[int(picks[i])])))))
        if not 0 <= gap <= band:
            raise AssertionError(f"sampled leg rid/step {pairs[i]}: the CPU "
                                 f"picks {int(picks[i])}, the card "
                                 f"{int(want[i])}, {gap:.3g} apart (band "
                                 f"{band:.3g})")
        near, worst = near + 1, max(worst, gap)
    # the draw alone, at a full tick's 8 rows of recorded logits
    lg8 = lo[:8, None].cuda()
    ids = torch.stack([rids[:8], steps[:8]]).long().cuda()
    key, sc = S.prng.PRNGKey(seed, "cuda"), scale.cuda()
    draw = lambda: S.paged.sample_tokens(lg8, key, sc, top_k, ids[0], ids[1])
    if not torch.equal(draw().cpu().flatten(), want[:8].int()):
        raise AssertionError("sampled leg: sample_tokens on 8 recorded rows "
                             "does not give the engine's tokens")
    # the draw is some 570 launches, more than the card's launch queue
    # holds behind device_ms's sleep: its device time is the profiler's
    # sum of its kernels
    kern, count, _ = traced_kernels(draw)
    tick = lambda run: 1e3 * float(np.mean(run["ticks"]["tick_s"]))
    out = {"tokens": len(pairs), "near_ties": near, "near_tie_worst": worst,
           "smallest_top2_gap": float(gaps.min()),
           "noise_max_diff": float(dg.max()),
           "noise_diff_share": float((dg > 0).double().mean()),
           "b6_launches": r["b6"],
           "ms_per_tick": tick(timed), "greedy_ms_per_tick": tick(greedy),
           "recorded_ms_per_tick": tick(r),
           "draw_ms": cuda_ms(draw),
           "draw_device_ms": sum(kern.values()) / 1e3,
           "draw_launches": sum(count.values()),
           "draw_kernels": len(count),
           "tok_per_s": len(pairs) / timed["wall_s"]}
    log(f"  (a) sampled leg (T {temp}, top-k {top_k}, seed {seed}): "
        f"{len(pairs)} tokens, {out['tok_per_s']:.1f} tok/s; "
        f"{out['ms_per_tick']:.2f} ms a tick (greedy "
        f"{out['greedy_ms_per_tick']:.2f}; "
        + ("neither records logits; the recorded sampled run "
           f"{out['recorded_ms_per_tick']:.2f}, its tokens the same"
           if timed is not r else "the sampled run records its logits")
        + f"); {r['b6']} B6 launches a run as the "
        f"greedy leg's; keys card = CPU bit for bit; CPU re-draw on the "
        f"card's logits: {near} near-ties (worst {worst:.3g}), smallest "
        f"top-two gap {out['smallest_top2_gap']:.3g}; f32 noise card vs "
        f"CPU apart in {out['noise_diff_share']:.1%} of draws, at most "
        f"{out['noise_max_diff']:.3g}; the draw at 8 rows "
        f"{out['draw_ms'] * 1e3:.1f} us ({out['draw_device_ms'] * 1e3:.1f} us "
        f"device), {out['draw_launches']} launches")
    return out


SERVE_PARITY_ARCHS = (("gemma3-4b", 2), ("phi3-mini-3.8b", 2))


def serve_parity_phase(S, archs=SERVE_PARITY_ARCHS, card_features=True):
    """Phase 13: the reduced gemma3-4b (uniform window 16) and phi3-mini
    in f32 on the card against the CPU port, on the churn workload:
    greedy tokens identical, logits within SERVE_PARITY_BAND, B6 a layer
    a decode tick; then (``card_features``) on the card spec_k=3 and
    prefix sharing token-identical to one-token decode (phase 28 (d):
    gemma3 at 6 layers, its mixed segment through the plain route at
    each layer's window, no B6)."""
    import numpy as np
    out = {}
    spec = S.PageSpec(page_len=16, pages_per_slot=4, n_slots=2)
    threads = torch.get_num_threads()
    for arch, layers in archs:
        cfg = S.reduced(S.get_config(arch), layers=layers)
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
        with _plain_route(S) as route:
            rc = card.serve(reqs)
        b6 = S.FD.launch_count("flash_decode_paged")
        want_route, b6_layers = _want_route(S, cfg, card.stats)
        if b6 != b6_layers * card.stats["decode_calls"] or \
                S.FD.plain_count() or route != want_route:
            raise AssertionError(f"{arch} reduced ({layers} layers): {b6} B6 "
                                 f"launches for {card.stats['decode_calls']} "
                                 f"decode calls, plain-route calls by window "
                                 f"{route} (expected {want_route})")
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
        log(f"serve parity {arch} reduced ({layers} layers, f32, windows "
            f"{S.paged.attention_segments(cfg)[0].windows}), card vs CPU: "
            f"tokens identical {same}, logit gap {gap:.3g} (band "
            f"{SERVE_PARITY_BAND:g}), smallest top-2 margin {margin:.3g}; "
            f"{b6} B6 launches, plain-route calls by window {route}")
        if not same or gap > SERVE_PARITY_BAND or card.log != cpu.log:
            raise AssertionError(f"{arch} reduced: the card and the CPU "
                                 "port disagree")
        key = arch if layers == 2 else f"{arch} {layers} layers"
        out[key] = {
            "tokens_identical": same, "logit_gap": gap, "min_margin": margin,
            "b6_launches": b6, "slot_attention_calls": route}
        if not card_features:
            continue
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
        out[key].update(spec_accept_rate=fast.accept_rate,
                        spec_margin=base_margin,
                        prefix_skip_frac=share.prefill_skip_frac)
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
PF_MODELS = ("zamba2-2.7b", "phi3-mini-3.8b", "gemma3-4b", "rwkv6-7b",
             GRANITE, SEAMLESS, "llama3-405b", "deepseek-67b", "arctic-480b")
# B4: (label, B, H, KV, Sq, Sk, hd, causal, windows) — the model geometries
# at the prefill main path's 2 x 2048 tokens (zamba2-2.7b's shared
# attention, phi3-mini-3.8b, gemma3-4b's local and global layers), then
# the shapes of the CPU tests: a ragged S with hd 64 and 80, the sweep of
# the reference's tests, and non-causal (cross-attention) ones; then the
# edges of the tensor-core form: hd 96 and 256 with GQA at a ragged S and a
# window (100) that is no multiple of a key tile; then granite-moe-3b-a800m
# (phase 22 (a): 24 / 8 heads of 64) at the prefill's 2 x 2048 and the
# static decode's 4 x 512 chunked prefill, and its reduced 6 / 2 heads at a
# ragged S; then seamless-m4t-large-v2 (phase 24: 16 / 16 heads of 64,
# non-causal): its encoder at 2 x 4096 frames, its cross-attention in the
# prefill (2 x 512 queries over 4096 keys) and in a decode step (4 rows of
# one query over 4096 keys, SEAMLESS_CROSS_DECODE, also timed against B5 on
# the same keys), and the reduced model's one-query cross-attention; then
# the heads of llama3-405b, deepseek-67b and arctic-480b (phase 25: hd 128
# at n_rep 16, 8 and 7) causal over 4096 tokens, a row (phase 25 (b)
# holds B4 at prefill_32k's 32,768 tokens, ``_b4_big_row``) (each timed:
# their labels start with a model's name)
SEAMLESS_CROSS_DECODE = f"{SEAMLESS} cross decode"
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
             ("hd256-gqa-ragged", 1, 8, 2, 200, 200, 256, True, (0, 100)),
             (GRANITE, 2, 24, 8, 2048, 2048, 64, True, (0,)),
             (f"{GRANITE} static", 4, 24, 8, 512, 512, 64, True, (0,)),
             (f"{GRANITE}-reduced-ragged", 2, 6, 2, 45, 45, 64, True, (0,)),
             (f"{SEAMLESS} encoder", 2, 16, 16, 4096, 4096, 64, False, (0,)),
             (f"{SEAMLESS} cross prefill", 2, 16, 16, 512, 4096, 64, False,
              (0,)),
             (SEAMLESS_CROSS_DECODE, 4, 16, 16, 1, 4096, 64, False, (0,)),
             (f"{SEAMLESS} reduced cross decode", 2, 4, 4, 1, 64, 64, False,
              (0,)),
             ("llama3-405b", 1, 128, 8, 4096, 4096, 128, True, (0,)),
             ("deepseek-67b", 1, 64, 8, 4096, 4096, 128, True, (0,)),
             ("arctic-480b", 1, 56, 8, 4096, 4096, 128, True, (0,)))
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
# zamba2 at 6 layers so that its shared block runs; gemma3 at 6 layers, its
# global layer among them, in phase 28 (d)), last-position logits
# of magnitude about 4: the kernels sum in other orders than the CPU's
# scans (B7 step by step where the CPU runs the chunked form)
PREFILL_PARITY_ARCHS = (("zamba2-2.7b", 6), ("rwkv6-7b", 2),
                        ("phi3-mini-3.8b", 2))
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


def _pf_bound(kernel, args, rate, window=0, causal=True, out_dtype=None):
    """(bound ms, bound_by, flops, bytes, op rate): the kernel's own work
    by the formula beside its wrapper (``flash_attention_work``,
    ``mamba_ssd_work``, ``wkv6_work``: each input read once, each output
    written once; the operations its algorithm does on these inputs, B4
    the causal / window band only) at the rate of the units it runs on —
    the bf16 forms of B4, B7 and B8's tensor-core route the dense bf16
    tensor-core rate (the chunked products, splits included), the rest
    the f32 rate of the CUDA cores (B7's f32 form the step recurrence)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mamba_scan as SSD
    from repro_torch.kernels import wkv6 as WKV
    op_rate = F32_RATE
    if kernel == "flash_attention":
        q, k, v = args
        flops, nbytes = FA.flash_attention_work(q, k, v, causal=causal,
                                                window=window)
        if q.dtype == torch.bfloat16:
            op_rate = BF16_RATE
    elif kernel == "mamba_ssd_scan":
        flops, nbytes = SSD.mamba_ssd_work(*args)
        if args[0].dtype == torch.bfloat16:
            op_rate = BF16_RATE
    else:
        r, k, v, w, u = args
        flops, nbytes = WKV.wkv6_work(r, k, v, w, u, out_dtype=out_dtype)
        if WKV.tensor_core_route(r, k):
            op_rate = BF16_RATE
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
                            q, k, v, is_causal=kw["causal"], enable_gqa=True)
                    rec["library_ms"] = cuda_ms(lib)
                    rec["vs_library"] = rec["ms"] / rec["library_ms"]
                    if label == SEAMLESS_CROSS_DECODE:
                        rec.update(_cross_decode_times(
                            P.FD, args, want, lambda: kern_fns[kernel](
                                *args, **kw), lib))
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


def _cross_decode_times(FD, args, want, kern, lib):
    """A decode step's cross-attention (one query over the encoder's keys)
    three ways, in device time (``device_ms``): B4 on the ``(B, KV, Sk,
    hd)`` copies ``chunked_attention`` makes, SDPA on the same, and B5 at
    pos = Sk - 1 with no window on the ``(B, Sk, KV, hd)`` projections as
    they lie (their ``transpose(1, 2)`` views), which computes the same
    function; B5 held to B4's plain version (PF_F32_TOL, bf16 one ulp
    more), and the time of the k / v copies B4's route makes."""
    q, k, v = args
    kl, vl = (t.transpose(1, 2).contiguous() for t in (k, v))  # as projected
    kt, vt = kl.transpose(1, 2), vl.transpose(1, 2)
    pos = k.shape[2] - 1
    b5 = lambda: FD.flash_decode(q, kt, vt, pos)
    err, ratio = _pf_err("flash_attention", b5(), want)
    if not ratio <= 1.0:
        raise AssertionError(f"flash_decode on the cross-attention's keys "
                             f"differs from B4's plain version by {err} "
                             f"({ratio:.3g} x the tolerance)")
    copies = lambda: (kl.transpose(1, 2).contiguous(),
                      vl.transpose(1, 2).contiguous())
    rec = {"device_ms": device_ms(kern), "library_device_ms": device_ms(lib),
           "b5_ms": cuda_ms(b5), "b5_device_ms": device_ms(b5),
           "b5_max_abs_err": err, "kv_copy_ms": cuda_ms(copies),
           "kv_copy_device_ms": device_ms(copies)}
    log(f"      one query over {k.shape[2]} keys ({q.dtype}): device time B4 "
        f"{rec['device_ms'] * 1e3:.1f} us, SDPA "
        f"{rec['library_device_ms'] * 1e3:.1f} us, B5 on the projections "
        f"as they lie {rec['b5_device_ms'] * 1e3:.1f} us (err {err:.3g}); "
        f"the k / v copies B4's route makes "
        f"{rec['kv_copy_device_ms'] * 1e3:.1f} us")
    return rec


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


def prefill_phase(P, archs=PREFILL_ARCHS, params=None):
    """Phase 15: ``make_prefill_step`` at full width in bf16 on 2 x 2048
    random tokens: zamba2-2.7b (45 B7 and 9 B4 launches a forward) and
    rwkv6-7b (32 B8), no plain runs, finite last-position logits; ms per
    prefill, tokens/s, a profile of one prefill and peak memory (phase 22
    (b): ``archs`` granite, 32 B4, with the MoE layer's split; phase 28
    (a): gemma3-4b on the ``params`` the phase drew, 34 B4).  Returns
    (records, launches per kernel of one forward)."""
    import numpy as np
    out, launches = {}, {k: 0 for k in PF_REFERENCE}
    for arch in archs:
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
        weights = params or P.models.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in P.tree_leaves(weights))
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in P.tree_leaves(weights))
        tokens = torch.from_numpy(np.random.default_rng(7).integers(
            0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ))).cuda()
        prefill = P.make_prefill_step(cfg)
        prefill(weights, tokens)                      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        P.reset_counts()
        logits = prefill(weights, tokens)
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
            prefill(weights, tokens)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = 1e3 * statistics.median(times)
        prof = _prefill_profile(prefill, weights, tokens, got["launches"])
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
        if cfg.moe:
            out[arch]["moe_split"] = _moe_split(P, prefill, weights, tokens)
        del weights, logits, prefill
        gc.collect()
        torch.cuda.empty_cache()
    return out, launches


def prefill_parity_phase(P, archs=PREFILL_PARITY_ARCHS):
    """Phase 16: reduced f32 models on the card (B4 / B7 / B8) against the
    CPU port (the XLA-scan ports) on the same params and tokens, within
    PREFILL_PARITY_BAND (phase 28 (d): gemma3-4b at 6 layers)."""
    import numpy as np
    out = {}
    threads = torch.get_num_threads()
    for arch, layers in archs:
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
           "--steps", "12"]
# 24 steps until phase 28 needed the time, 40 until phase 25's serving did
LM_STEPS, LM_SEQS = 12, (64, 128)
# a training run shorter than this need not lower its loss (granite's and
# rwkv6's runs of 4 steps); phi3's must
LOSS_FALL_STEPS = 10
# the card's memory: a training run's peak must stay under it
CARD_BYTES = 80e9
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


def b1_store_check(K, rows, rate, arch=LM_ARCH):
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
    rec = {"variant": "plain", "shape": f"{arch} store",
           "rows": rows, "elements": n,
           "replaces": f"{REFERENCE}:{B1['plain'][0]}", "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes", "library_ms": library_ms,
           "bytes": n * 12}
    log(f"  dbl_apply_flat2d[plain] at the {arch} store ({rows} x 128 "
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


def _step_profile(L, engine, fspec, p2, phase, batch, runs=3):
    """One fused step of ``phase`` on the flat store ``p2``: CUDA-event ms
    (median of ``runs``, after a warm-up unless ``runs`` is 1: the
    caller's own run warmed it), then its kernels under the profiler —
    device busy and idle share, top kernels, B1's share."""
    fn, _ = engine.phase_fn(phase, fspec)
    batches = {k: torch.as_tensor(v)[None].cuda() for k, v in batch.items()}
    step = lambda: fn(p2, None, batches, None)
    if runs > 1:                 # one run times a step its caller warmed
        step()
    times = []
    for _ in range(runs):
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


def _profile_sub_stages(L, cfg, argv, res, engine, fspec, phases,
                        which=None, runs=3):
    """One profiled fused step per sub-stage (those whose indices are in
    ``which``, every one when None; ``runs`` timed) on a training run's
    final params (``_step_profile``), on the CLI's own data stream; the
    run's params and optimizer state are dropped first.  Returns the
    records."""
    res.opt_state = None
    p2 = fspec.ravel(res.params)
    res.params = None
    args = L.train.parser().parse_args(argv)
    plane = L.DataPlane(L.SyntheticTokens(
        vocab=min(cfg.vocab_size, 256), seed=args.seed,
        n_examples=max(4096, args.global_batch * 64)), seed=args.seed)
    plane.bind(phases)
    profiles, g0 = [], 0
    for i, ph in enumerate(phases):
        g0 += ph.n_steps
        if which is not None and i not in which:
            continue
        prof = _step_profile(L, engine, fspec, p2, ph,
                             plane(ph, g0 - ph.n_steps), runs)
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
    return profiles


def lm_train_phase(L, rate, arch=LM_ARCH, argv=LM_ARGV, steps=LM_STEPS,
                   seqs=LM_SEQS, layers=None, which=None, runs=3):
    """Phase 18: the LM training main path at full width.  B1 at the
    model's flat-store shape first (the store's geometry read from a
    model built and freed before), then ``launch.train.run`` on
    ``LM_ARGV``: one B1 launch a step and no B4 / B7 / B8, the sequence
    lengths ``seqs``, finite losses, the last below the first in a run of
    LOSS_FALL_STEPS or more, peak memory under the card's, params on the
    card; per sub-stage ms per step, tokens/s, time to its first step,
    and a profiled step (``_profile_sub_stages``'s ``which`` and
    ``runs``); peak memory.  Phase 22 (e) runs it on granite (``arch``,
    ``argv``, ``steps``; the aux loss of the trained params finite and >
    0), phase 27 (b) on rwkv6 with the config cut to ``layers``
    (``train.get_config`` wrapped for the run).  Returns (record, B1's
    store record)."""
    from dataclasses import replace
    cfg = L.get_config(arch)
    if layers is not None:
        cfg = replace(cfg, n_layers=layers)
    params = L.models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    fspec = L.flat_spec(params)
    rows, n_live = fspec.rows, fspec.n
    del params
    gc.collect()
    torch.cuda.empty_cache()
    b1 = b1_store_check(L.K, rows, rate, arch)

    real = L.train.get_config
    if layers is not None:
        L.train.get_config = lambda a: replace(real(a), n_layers=layers)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_lm_counts(L)
        t0 = time.perf_counter()
        with _CaptureRun(L.train) as cap:
            hist = L.train.run(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        L.train.get_config = real
    peak = torch.cuda.max_memory_allocated()
    got = _lm_counts(L)
    res, engine = cap.res, cap.engine
    losses = [h["loss"] for h in hist]
    got_seqs = tuple(sorted({h["seq"] for h in hist}))
    b1_launches = got["dbl"]["dbl_apply_flat2d"]
    if b1_launches != steps or sum(got["dbl"].values()) != steps \
            or got["dbl_plain"] or got["prefill"]:
        raise AssertionError(f"{arch} training: launches {got}; expected "
                             "one dbl_apply_flat2d launch a step and no B4 "
                             "/ B7 / B8 call")
    if len(losses) != steps or got_seqs != seqs:
        raise AssertionError(f"{arch} training: {len(losses)} steps at "
                             f"sequence lengths {got_seqs}")
    if not all(math.isfinite(x) for x in losses) or \
            not (steps < LOSS_FALL_STEPS or losses[-1] < losses[0]):
        raise AssertionError(f"{arch} training losses: {losses}")
    if peak >= CARD_BYTES:
        raise AssertionError(f"{arch} training: peak {peak / 1e9:.1f} GB")
    if any(t.device.type != "cuda" for t in L.tree_leaves(res.params)) or \
            L.flat_spec(res.params).shape != fspec.shape:
        raise AssertionError(f"{arch} params left the card or changed "
                             "geometry")
    aux = None
    if cfg.moe:
        # the load-balance loss of the trained params on one sequence
        with torch.no_grad():
            tok = torch.randint(0, cfg.vocab_size, (2, seqs[-1]),
                                generator=torch.Generator().manual_seed(5))
            aux = float(L.models.forward(res.params, cfg, tok.cuda(),
                                         return_aux=True)[1])
        if not (math.isfinite(aux) and aux > 0):
            raise AssertionError(f"{arch}: aux loss {aux} of the trained "
                                 "params")
    phases = L.train.build_spec(
        L.train.parser().parse_args(argv)).to_phases()
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
    depth = "" if layers is None else \
        f", {layers} of {real(arch).n_layers} layers"
    log(f"LM main path: {arch} full width{depth} ({n_live / 1e9:.3f} B "
        f"params, bf16, remat {cfg.remat}), {steps} steps in {wall:.2f} s "
        f"(model build included); peak memory {peak / 2**30:.2f} GiB; "
        f"{b1_launches} dbl_apply_flat2d launches, no B4 / B7 / B8")
    for s in sub:
        log(f"  seq {s['input_size']} x batch {s['batch']}: {s['steps']} "
            f"steps, {s['ms_per_step']:.1f} ms/step, {s['tokens_per_s']:.0f} "
            f"tokens/s ({s['tokens_per_step']:.0f} trained tokens a step), "
            f"first step after {s['first_step_s']:.2f} s")
    log(f"  losses: {losses}" + ("" if aux is None else
                                 f"; aux loss of the trained params {aux}"))

    profiles = _profile_sub_stages(L, cfg, argv, res, engine, fspec, phases,
                                   which, runs)
    del res, engine
    cap.res = cap.engine = None
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "argv": argv, "layers": cfg.n_layers,
            "params": n_live, "store_rows": rows, "wall_s": wall,
            "peak_bytes": peak, "launches": got["dbl"], "losses": losses,
            "aux": aux, "sub_stages": sub, "profiles": profiles}, b1


def _train_run(L, cfg, params, form, device, args=TRAIN_PARITY_ARGS):
    """A few dual-batch steps of ``args`` through ``api.run`` on
    ``device``: ``form`` "fused" (B1 a step), "per_step" (B2 a step) or
    "adamw" (the weighted step).  Returns (RunResult, counts)."""
    import argparse
    spec = L.train.build_spec(argparse.Namespace(**args))
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


# ----------------- phase 27: rwkv6-7b LM training at 4,096 -----------------
# the RWKV-6 family's training path at full width (d_model 4096, 64 heads
# of 64, d_ff 14336, vocab 65536) through the training CLI's run: hybrid
# dual-batch x CPL (seq 2048 -> 4096), fused SGD, B1 on the f32 store, the
# WKV scan in its chunked, checkpointed training form.  Depth is cut as
# far as 80 GB forces: 0.218 G parameters a layer and 0.537 G of
# embeddings and head, at about 15 bytes a parameter on this path (the
# f32 store, bf16 weights and grads, the f32 gradient buffer; phase 18's
# phi3 peaks there) plus the activations of 16,384 tokens a step, gives
# 12 of 32 layers (3.16 G parameters).  The global batch is the smallest
# the dual-batch layout takes at seq 4096 (4 workers, one row each; CPL
# doubles it at 2048), cut from train_4k's 256.
RWKV_ARCH = "rwkv6-7b"
RWKV_TRAIN_LAYERS = 12
RWKV_TRAIN_STEPS = 4
RWKV_TRAIN_ARGV = ["--arch", RWKV_ARCH, "--full", "--optimizer", "sgd",
                   "--scheme", "hybrid", "--seq", "4096", "--global-batch",
                   "4", "--lr", "5e-3", "--steps", str(RWKV_TRAIN_STEPS)]
RWKV_SEQS = (2048, 4096)
# one full-width layer's training forward and backward at 4,096 tokens, one
# row: the chunked scan (blocks of rwkv6.SUB inside each chunk), its
# one-level form (one block a chunk: the (q, q, K) decay tensor of every
# pair) and the per-token form (ref.wkv6_ref)
RWKV_LAYER_SEQ = 4096
RWKV_CHUNK = 64          # wkv6_scan's default chunk, the reference's
# runs of each chunked form's forward + backward (the first warms it up)
RWKV_LAYER_RUNS = 4
# the forms' f32 scan outputs there, relative to the largest (on the CPU
# each lies within about 1e-7 of it from a float64 recurrence,
# tests/test_torch_wkv_train.py)
WKV_FORMS_BAND = 1e-5
# card vs CPU: phase 19's reduced rwkv6 setup at seq 256, four chunks of 64
RWKV_PARITY_ARGS = dict(TRAIN_PARITY_ARGS, seq=256)


def _wkv_layer_memory(L):
    """One rwkv6-7b layer (full width, bf16, one row of RWKV_LAYER_SEQ
    tokens): its training forward (``time_mix(train=True)``,
    ``channel_mix``) with the chunked scan, its one-level form and the
    per-token form: the bytes autograd keeps for the backward (allocated
    after the forward less before it and the output), the scans' f32
    outputs against the per-token one's; for the two chunked forms the
    forward and backward seconds on the host clock, each ending in a
    sync (median of RWKV_LAYER_RUNS - 1 after a warm-up), and the peak
    (the per-token backward would take 8-9 s and teaches nothing
    more)."""
    from repro_torch.kernels.ref import wkv6_ref
    from repro_torch.models import rwkv6
    cfg = L.get_config(RWKV_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(27)
    p = rwkv6.init_rwkv6(lambda shape, sc, dt: (torch.randn(
        shape, generator=gen, device="cuda") * sc).to(dt), cfg,
        torch.bfloat16)
    p = {k: t.requires_grad_() for k, t in p.items()}
    x = (torch.randn(1, RWKV_LAYER_SEQ, cfg.d_model, generator=gen,
                     device="cuda") * 0.5).bfloat16().requires_grad_()
    real, sub = rwkv6.wkv6_scan, rwkv6.SUB
    per_token = lambda r, k, v, w, u, state: wkv6_ref(
        r, k, v, w, u, state=state, out_dtype=torch.float32)
    out, ys = {}, {}

    def keep(scan, form):
        def run(*a):
            y, st = scan(*a)
            ys[form] = y.detach().clone()
            return y, st
        return run

    def forward():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, _, _ = rwkv6.time_mix(p, x, cfg, train=True)
        y, _ = rwkv6.channel_mix(p, y, cfg)
        torch.cuda.synchronize()
        return y, time.perf_counter() - t0

    forms = (("chunked", real, sub), ("one_level", real, RWKV_CHUNK),
             ("per_token", per_token, sub))
    for form, scan, block in forms:
        rwkv6.wkv6_scan, rwkv6.SUB = keep(scan, form), block
        try:
            torch.cuda.reset_peak_memory_stats()
            m0 = torch.cuda.memory_allocated()
            y, fwd = forward()
            saved = torch.cuda.memory_allocated() - m0 - \
                y.numel() * y.element_size()
            out[form] = {"saved_bytes": saved, "forward_s": fwd}
            if form != "per_token":
                fwds, bwds = [], []
                for i in range(RWKV_LAYER_RUNS):
                    if i:
                        y, fwd = forward()
                    t1 = time.perf_counter()
                    g = torch.autograd.grad(y.float().square().mean(),
                                            [x, p["w0"]])
                    torch.cuda.synchronize()
                    if i:
                        fwds.append(fwd)
                        bwds.append(time.perf_counter() - t1)
                    del y
                out[form].update(
                    forward_s=statistics.median(fwds),
                    backward_s=statistics.median(bwds),
                    forward_runs_s=fwds, backward_runs_s=bwds,
                    peak_bytes=torch.cuda.max_memory_allocated() - m0,
                    grads_finite=all(bool(t.isfinite().all()) for t in g))
                del g
            else:
                del y
        finally:
            rwkv6.wkv6_scan, rwkv6.SUB = real, sub
    scale = max(float(ys["per_token"].abs().max()), 1e-30)
    for form in ("chunked", "one_level"):
        out[form]["y_gap_relative"] = float(
            (ys[form] - ys["per_token"]).abs().max()) / scale
    del p, x, ys
    gc.collect()
    torch.cuda.empty_cache()
    pt = out["per_token"]
    log(f"  one {RWKV_ARCH} layer at {RWKV_LAYER_SEQ} tokens (one row): "
        f"autograd keeps {pt['saved_bytes'] / 2**30:.2f} GiB for the "
        f"backward per token, forward {pt['forward_s']:.2f} s")
    for form, block in (("chunked", sub), ("one_level", RWKV_CHUNK)):
        o = out[form]
        log(f"    {form} (blocks of {block} in chunks of {RWKV_CHUNK}): "
            f"keeps {o['saved_bytes'] / 2**30:.2f} GiB; forward "
            f"{o['forward_s'] * 1e3:.1f} ms, backward "
            f"{o['backward_s'] * 1e3:.1f} ms (medians of runs "
            f"{[round(t * 1e3, 1) for t in o['forward_runs_s']]} / "
            f"{[round(t * 1e3, 1) for t in o['backward_runs_s']]}), peak "
            f"{o['peak_bytes'] / 2**30:.2f} GiB; f32 output "
            f"{o['y_gap_relative']:.3g} from the per-token form's "
            "(relative to the largest)")
        if not (o["saved_bytes"] * 4 < pt["saved_bytes"]
                and o["y_gap_relative"] <= WKV_FORMS_BAND
                and o["grads_finite"]):
            raise AssertionError(f"the chunked WKV scan's layer: {out}")
    return out


def rwkv_train_phase(L, rate):
    """Phase 27: rwkv6-7b LM training at 4,096 tokens.  (a) One layer's
    saved memory and times, the chunked scan against the per-token form
    and its one-level form.  (b) The main path, phase 18's
    ``lm_train_phase`` on RWKV_TRAIN_ARGV with the config cut to
    RWKV_TRAIN_LAYERS: B1 at that store's shape against its plain
    version, then the run (one B1 launch a step and no B4 / B7 / B8, both
    sequence lengths, finite losses, peak memory under the card's 80 GB)
    and the step at 4,096 tokens profiled once (idle share, kernel count,
    B1's share).  (c) Phase 19's reduced rwkv6 at seq 256 (four chunks),
    fused, card vs CPU within TRAIN_PARITY_BAND.  Returns (record, B1
    launches of (b) and (c), B1's record at the rwkv6 store)."""
    out = {"layer": _wkv_layer_memory(L)}
    main, b1_store = lm_train_phase(
        L, rate, RWKV_ARCH, RWKV_TRAIN_ARGV, RWKV_TRAIN_STEPS, RWKV_SEQS,
        layers=RWKV_TRAIN_LAYERS, which=(len(RWKV_SEQS) - 1,), runs=1)
    out.update(main)

    # (c) card vs CPU on phase 19's reduced rwkv6, four chunks a sequence
    small = L.reduced(L.get_config(RWKV_ARCH), layers=2)
    p0 = L.models.init_params(small, torch.Generator().manual_seed(0),
                              device="cpu")
    card, cc = _train_run(L, small, p0, "fused", "cuda", RWKV_PARITY_ARGS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu, _ = _train_run(L, small, p0, "fused", "cpu", RWKV_PARITY_ARGS)
    finally:
        torch.set_num_threads(threads)
    steps = RWKV_PARITY_ARGS["steps"]
    lc = [h["loss"] for h in card.history]
    lp = [h["loss"] for h in cpu.history]
    rec = {"loss_gap": max(abs(a - b) for a, b in zip(lc, lp)),
           "param_gap": _leaf_gaps(L.tree_leaves(card.params),
                                   L.tree_leaves(cpu.params)),
           "losses": lc, "launches": cc["dbl"]["dbl_apply_flat2d"]}
    log(f"  LM parity {RWKV_ARCH} reduced (2 layers, f32, seq "
        f"{RWKV_PARITY_ARGS['seq']}: four chunks of 64) fused, card vs CPU "
        f"over {steps} steps: loss gap {rec['loss_gap']:.3g}, param gap "
        f"{rec['param_gap']:.3g}; {rec['launches']} dbl_apply_flat2d "
        "launches")
    if rec["launches"] != steps or cc["prefill"] or len(lc) != steps or \
            rec["loss_gap"] > TRAIN_PARITY_BAND["loss"] or \
            rec["param_gap"] > TRAIN_PARITY_BAND["params"]:
        raise AssertionError(f"{RWKV_ARCH} at seq {RWKV_PARITY_ARGS['seq']}:"
                             f" the card and the CPU port disagree beyond "
                             f"{TRAIN_PARITY_BAND}: {rec}")
    out["parity"] = rec
    return out, out["launches"]["dbl_apply_flat2d"] + rec["launches"], \
        b1_store


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


# --------------------------- phase 21: static decode -------------------------
# the static decode main path (launch.serve.generate): phi3-mini-3.8b at
# full width and depth, bf16, 4 prompts of 512 tokens (one chunked prefill,
# B4 with q_offset 0 in every layer) and 64 generated (63 one-token decode
# steps, B5 in every layer), the cache 576 positions
DEC_ARCH = "phi3-mini-3.8b"
DEC_BATCH, DEC_PROMPT, DEC_GEN = 4, 512, 64
# the recurrent and hybrid stacks at full width: 4 x 32 prompt tokens
# stepped, 32 generated (zamba2-2.7b: B5 in its 9 shared-block calls a step)
DEC_SHORT_ARCHS = ("zamba2-2.7b", "rwkv6-7b")
DEC_SHORT_PROMPT, DEC_SHORT_GEN = 32, 32
# B5 on the models' (B, S, KV, hd) layer cache, read through its
# transpose(1, 2) view: (label, rows, heads, kv heads, hd, max_seq, window)
# at the static decode geometries of phi3-mini-3.8b, gemma3-4b (its local
# layers' window over a 2048-position cache) and zamba2-2.7b's shared
# attention (hd 80), then granite-moe-3b-a800m (phase 22 (a): n_rep 3, hd
# 64) at its static decode's geometry and reduced, then the decoder of
# seamless-m4t-large-v2 (phase 24: n_rep 1, hd 64) at its static decode's
# (4 rows, a cache of 128), then the heads of llama3-405b, deepseek-67b
# and arctic-480b (phase 25: hd 128 at n_rep 16, 8 and 7) on a cache of
# 576; positions 0, the middle and max_seq - 1, timed at the last (phase 25
# adds B5 at decode_32k's and long_500k's own caches, ``_b5_big_row``)
B5_SHAPES = (("phi3-mini-3.8b static", 4, 32, 32, 96, 576, 0),
             ("gemma3-4b static", 4, 8, 4, 256, 2048, 1024),
             ("zamba2-2.7b static", 4, 32, 32, 80, 64, 0),
             (f"{GRANITE} static", 4, 24, 8, 64, 576, 0),
             (f"{GRANITE}-reduced static", 2, 6, 2, 64, 28, 0),
             (f"{SEAMLESS} static", 4, 16, 16, 64, 128, 0),
             ("llama3-405b static", 4, 128, 8, 128, 576, 0),
             ("deepseek-67b static", 4, 64, 8, 128, 576, 0),
             ("arctic-480b static", 4, 56, 8, 128, 576, 0))
# B4 with a query offset at phi3-mini's attention (4 rows, 32 heads, hd
# 96): queries at offset..offset+T-1 over the first offset + T keys
B4_OFFSETS, B4_CHUNKS, B4_WINDOWS = (0, 1, 17, 512), (1, 5, 64), (0, 100)
# B4 on the (B, S, KV, hd) layer cache through its transpose(1, 2) view at
# a device offset (the decode step's chunk route): (label, rows, heads, kv
# heads, hd, max_seq, window, offsets) — phi3-mini's static cache (576: the
# chunk at 512 is its last) and gemma3-4b's local layers (window 1024 over
# 2048) and a global one, each with a 64-token chunk at 512 and at the
# cache's last chunk
B4_CACHE_CHUNK = 64
B4_CACHE_SHAPES = (("phi3-mini-3.8b static", 4, 32, 32, 96, 576, 0, (512,)),
                   ("gemma3-4b static", 4, 8, 4, 256, 2048, 1024,
                    (512, 1984)),
                   ("gemma3-4b static global", 4, 8, 4, 256, 2048, 0,
                    (512, 1984)))
# card vs CPU port on the reduced f32 configs (zamba2 at 6 layers so that
# its shared block runs; gemma3 in phase 28 (d), at 6 layers, its window 16
# below prompt + generation):
# greedy tokens identical, the generated tokens' logits (magnitude about
# 4) within this band, as the prefill parity's
DECODE_PARITY_ARCHS = (("phi3-mini-3.8b", 2), ("zamba2-2.7b", 6),
                       ("rwkv6-7b", 2))
DECODE_PARITY_PROMPT, DECODE_PARITY_GEN = 20, 8
DECODE_PARITY_BAND = 1e-4
PAGED_DRAWS = 4          # prompt draws of the static-vs-paged comparison
# phase 21 (b), sampled: generate(greedy=False) on phi3's prompts with the
# key PRNGKey(0); (c) reduced f32 phi3-mini sampled on the card and the CPU:
# the engine at T 0.8, top-k 32, seed 11 on 4 repetitive requests (pages
# of 16, 4 a slot, 2 slots, chunks of 16), generate with PRNGKey(5)
DEC_SAMPLE_SEED, PARITY_SAMPLE_SEED = 0, 5
PARITY_SAMPLE_KW = dict(prefill_chunk=16, temperature=0.8, top_k=32,
                        sample_seed=11)
PARITY_SAMPLE_SPEC = dict(page_len=16, pages_per_slot=4, n_slots=2)


def _b5_bound(q, kt, pos, w, rate):
    """(bound ms, bound_by, bytes): each live K/V row read once, q read
    and the output written once; 4·hd operations a (query head, key)."""
    rows, h, _, hd = q.shape
    kvh, s = kt.shape[1], kt.shape[2]
    live = _live(pos, s, w) * rows
    nbytes = live * kvh * hd * 2 * kt.element_size() \
        + 2 * q.numel() * q.element_size()
    t_b, t_o = nbytes / rate, live * h * hd * 4 / F32_RATE
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations", \
        nbytes


def _b5_static_inputs(si, qd, kd):
    """q and the (B, S, KV, hd) layer caches of B5_SHAPES[si] on the card
    (a seeded draw), the caches as B5 reads them: their transpose(1, 2)
    views, in place."""
    _, rows, h, kvh, hd, s, _ = B5_SHAPES[si]
    gen = torch.Generator(device="cuda").manual_seed(300 + si)
    q = torch.randn(rows, h, 1, hd, generator=gen, device="cuda").to(qd)
    kc, vc = (torch.randn(rows, s, kvh, hd, generator=gen,
                          device="cuda").to(kd) for _ in "kv")
    return q, kc.transpose(1, 2), vc.transpose(1, 2)


def _b5_time(FD, q, kt, vt, pos, w, rate):
    """B5's event and device times at the size the wrapper chooses, and
    its bytes bound; for a wrapper that takes ``pos`` on the card (the
    split-key B5), also the device time of that form, which the decode
    path runs (``device_ms_pos_on_card``)."""
    kern = lambda: FD.flash_decode(q, kt, vt, pos, window=w)
    bound_ms, by, nbytes = _b5_bound(q, kt, pos, w, rate)
    rec = {"ms": cuda_ms(kern), "device_ms": device_ms(kern),
           "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes}
    if hasattr(FD, "decode_cluster_size"):
        on_card = torch.tensor(pos, dtype=torch.int32, device="cuda")
        rec["device_ms_pos_on_card"] = device_ms(
            lambda: FD.flash_decode(q, kt, vt, on_card, window=w))
    return rec


def b5_static_phase(D, rate):
    """Phase 21 (a), B5: on the reference's strided cache at every shape of
    B5_SHAPES, q and cache each in f32 and bf16, at positions 0, the middle
    and max_seq - 1, at every cluster size, against its plain version
    (FD_F32_TOL; bf16 outputs one bf16 ulp more), with the position also
    as a 0-d int32 tensor on the card (bit-equal to the host int); one
    launch captured in a CUDA graph and replayed at the three positions
    (bit-equal to eager launches); timed at max_seq - 1 (q and cache of
    one dtype) beside the plain version, SDPA and the bytes bound, at the
    size the wrapper chooses and at every size."""
    out = []
    for si, (label, rows, h, kvh, hd, s, w) in enumerate(B5_SHAPES):
        for qd in (torch.bfloat16, torch.float32):
            for kd in (torch.bfloat16, torch.float32):
                q, kt, vt = _b5_static_inputs(si, qd, kd)
                for pos in (0, s // 2, s - 1):
                    timed = pos == s - 1 and qd == kd
                    plain = lambda: D.FD._xla_decode(q, kt, vt, pos, window=w)
                    ref = plain()
                    err, ok, worst = _fd_err(
                        D.FD.flash_decode(q, kt, vt, pos, window=w), ref)
                    if not ok:
                        raise AssertionError(
                            f"flash_decode {label} q {qd} cache {kd} pos "
                            f"{pos}: kernel differs from its plain version "
                            f"by {err}; worst (index, kernel, plain, diff / "
                            f"tolerance) {worst}")
                    rec = {"shape": label, "q": str(qd)[6:],
                           "cache": str(kd)[6:], "layout": "(B, S, KV, hd)",
                           "pos": pos, "window": w, "max_abs_err": err}
                    rec.update(_b5_splits(D.FD, q, kt, vt, pos, w, ref,
                                          label, timed))
                    if timed:
                        idx = torch.arange(s, device="cuda")
                        lo = max(0, pos - w + 1) if w > 0 else 0
                        mask = ((idx <= pos) & (idx >= lo))[None, None, None]
                        rec.update(_b5_time(D.FD, q, kt, vt, pos, w, rate),
                                   plain_ms=cuda_ms(plain),
                                   library_ms=cuda_ms(
                                       lambda: F.scaled_dot_product_attention(
                                           q, kt, vt, attn_mask=mask,
                                           enable_gqa=True)))
                        _b5_replay(D.FD, q, kt, vt, w, (0, s // 2, s - 1),
                                   label)
                        d = rec["split_device_ms"]
                        log(f"    flash_decode {label} {rec['q']} (B, S, KV, "
                            f"hd) cache, pos {pos}: kernel "
                            f"{rec['ms'] * 1e3:.1f} us (device "
                            f"{rec['device_ms'] * 1e3:.1f}, pos on the card "
                            f"{rec['device_ms_pos_on_card'] * 1e3:.1f}; "
                            f"cluster {rec['split']}), plain "
                            f"{rec['plain_ms'] * 1e3:.1f} us, SDPA "
                            f"{rec['library_ms'] * 1e3:.1f} us, bound "
                            f"{rec['bound_ms'] * 1e3:.1f} us by "
                            f"{rec['bound_by']} ({rec['bound_ms'] / rec['device_ms']:.0%} "
                            f"of device time), err {err:.3g}; device time by "
                            "cluster size " + ", ".join(
                                f"{c}: {t * 1e3:.1f} us"
                                for c, t in d.items()))
                    out.append(rec)
                del q, kt, vt
        log(f"  B5 {label}: rows {rows}, heads {h}/{kvh}, hd {hd}, cache "
            f"(B, {s}, KV, hd), window {w}: within tolerance of the plain "
            "version (q and cache bf16 / f32, 3 positions, every cluster "
            "size), the device pos bit-equal to the host int, a captured "
            "launch replayed at 3 positions bit-equal to eager launches")
    return out


def b5_times(FD, rate):
    """B5 alone, timed (events and device time, at the cluster size the
    wrapper chooses, the position a host int) at the timed forms of phase
    11 (phi3-mini and gemma3-4b, q bf16, f32 and bf16 caches, contiguous)
    and phase 21 (a) (B5_SHAPES at max_seq - 1, q and cache of one dtype):
    the records of ``--b5-times``, which runs them from another checkout
    of the port (a parent's) to compare in one call."""
    out = []
    for si, shape in enumerate(FD_SHAPES[:2]):
        label, w, pos = shape[0], shape[9][0], shape[8] - 7
        for kd in (torch.float32, torch.bfloat16):
            q, _, _, _, _, kc, vc, _ = _fd_inputs(shape, torch.bfloat16, kd,
                                                  seed=100 + si)
            out.append({"shape": label, "q": "bfloat16",
                        "cache": str(kd)[6:], "pos": pos, "window": w,
                        **_b5_time(FD, q, kc, vc, pos, w, rate)})
    for si, (label, _, _, _, _, s, w) in enumerate(B5_SHAPES):
        for dt in (torch.bfloat16, torch.float32):
            q, kt, vt = _b5_static_inputs(si, dt, dt)
            out.append({"shape": label, "q": str(dt)[6:],
                        "cache": str(dt)[6:], "pos": s - 1, "window": w,
                        **_b5_time(FD, q, kt, vt, s - 1, w, rate)})
    for r in out:
        log(f"  B5 {r['shape']} q {r['q']} cache {r['cache']}: "
            f"{r['ms'] * 1e3:.2f} us, device {r['device_ms'] * 1e3:.2f} us"
            + (f", pos on the card {r['device_ms_pos_on_card'] * 1e3:.2f} "
               "us" if "device_ms_pos_on_card" in r else "")
            + f" (bound {r['bound_ms'] * 1e3:.2f} us)")
    return out


def _offset_pairs(t: int, off: int, window: int) -> int:
    """(query, key) pairs B4 computes for queries at off..off+t-1 over the
    first off + t keys."""
    return sum(min(off + i + 1, window) if window > 0 else off + i + 1
               for i in range(t))


def b4_offset_phase(D, rate):
    """Phase 21 (a), B4: the query-offset form at phi3-mini's heads for
    every offset, chunk length and window of B4_OFFSETS / B4_CHUNKS /
    B4_WINDOWS in f32 and bf16, against its plain version (PF_F32_TOL;
    bf16 one ulp more); timed beside its plain version, SDPA and its bound
    at the decode path's two forms: a 64-token chunk at 512 and the
    main path's 512-token prefill at 0."""
    b, h, kvh, hd = 4, 32, 32, 96
    out = []
    cases = [(off, t, w) for off in B4_OFFSETS for t in B4_CHUNKS
             for w in B4_WINDOWS] + [(0, DEC_PROMPT, 0)]
    for dtype in (torch.float32, torch.bfloat16):
        for ci, (off, t, w) in enumerate(cases):
            gen = torch.Generator(device="cuda").manual_seed(400 + ci)
            q = torch.randn(b, h, t, hd, generator=gen, device="cuda") \
                .to(dtype)
            k, v = (torch.randn(b, kvh, off + t, hd, generator=gen,
                                device="cuda").to(dtype) for _ in "kv")
            kern = lambda: D.FA.flash_attention(q, k, v, window=w,
                                                q_offset=off)
            plain = lambda: D.FA.flash_attention_plain(q, k, v, window=w,
                                                       q_offset=off)
            err, ratio = _pf_err("flash_attention", kern(), plain())
            if not ratio <= 1.0:
                raise AssertionError(
                    f"flash_attention q_offset {off} T {t} window {w} "
                    f"{dtype}: kernel differs from its plain version by "
                    f"{err} ({ratio:.3g} x the tolerance)")
            rec = {"shape": "phi3-mini-3.8b static", "dtype": str(dtype)[6:],
                   "q_offset": off, "chunk": t, "window": w,
                   "max_abs_err": err, "err_over_tol": ratio}
            if w == 0 and ((off, t) == (512, 64) or
                           (t == DEC_PROMPT and dtype == torch.bfloat16)):
                flops = 4 * hd * b * h * _offset_pairs(t, off, w)
                nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                    * q.element_size()
                op_rate = BF16_RATE if dtype == torch.bfloat16 else F32_RATE
                t_b, t_o = nbytes / rate, flops / op_rate
                i = off + torch.arange(t, device="cuda")
                j = torch.arange(off + t, device="cuda")
                mask = j[None, :] <= i[:, None]
                rec.update(
                    ms=cuda_ms(kern), device_ms=device_ms(kern),
                    plain_ms=cuda_ms(plain, per_group=3, groups=3, warmup=1),
                    bound_ms=1e3 * max(t_b, t_o),
                    bound_by="bytes" if t_b >= t_o else "operations",
                    flops=flops, bytes=nbytes,
                    library_ms=cuda_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=mask, enable_gqa=True)))
                log(f"    flash_attention q_offset {off}, T {t} over "
                    f"{off + t} keys, {rec['dtype']}: kernel "
                    f"{rec['ms'] * 1e3:.1f} us (device "
                    f"{rec['device_ms'] * 1e3:.1f}), plain "
                    f"{rec['plain_ms'] * 1e3:.1f} us, SDPA "
                    f"{rec['library_ms'] * 1e3:.1f} us, bound "
                    f"{rec['bound_ms'] * 1e3:.1f} us by {rec['bound_by']}, "
                    f"err {err:.3g}")
            out.append(rec)
            del q, k, v
    log(f"  B4 with a query offset: {len(out)} cases within tolerance of the "
        f"plain version (worst {max(r['err_over_tol'] for r in out):.3g} x "
        "the tolerance)")
    return out


def b4_cache_phase(D, rate):
    """Phase 21 (a), B4 on the layer cache: a chunk of B4_CACHE_CHUNK
    queries at a 0-d int32 offset on the card over a whole ``(B, S, KV,
    hd)`` cache read through its ``transpose(1, 2)`` view (the decode
    step's route), against its plain version on the same views
    (PF_F32_TOL; bf16 one ulp more) and bit for bit against the route it
    replaces: a host-int offset over a contiguous copy of the first
    ``pos + T`` keys (the same key tiles in the same order).  Each row
    timed beside its bound (``flash_attention_work``: the keys the mask
    keeps), its plain version, SDPA on the same keys and views, and the
    replaced route with its copies."""
    out = []
    t = B4_CACHE_CHUNK
    for label, b, h, kvh, hd, max_seq, w, offsets in B4_CACHE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for off in offsets:
                gen = torch.Generator(device="cuda").manual_seed(
                    500 + off + hd)
                q = torch.randn(b, h, t, hd, generator=gen,
                                device="cuda").to(dtype)
                kc, vc = (torch.randn(b, max_seq, kvh, hd, generator=gen,
                                      device="cuda").to(dtype) for _ in "kv")
                k, v = kc.transpose(1, 2), vc.transpose(1, 2)
                pos = torch.tensor(off, dtype=torch.int32, device="cuda")
                kern = lambda: D.FA.flash_attention(q, k, v, window=w,
                                                    q_offset=pos)
                plain = lambda: D.FA.flash_attention_plain(
                    q, k, v, window=w, q_offset=pos)
                n = off + t

                def copied():
                    kk, vv = (c[:, :n].transpose(1, 2).contiguous()
                              for c in (kc, vc))
                    return D.FA.flash_attention(q, kk, vv, window=w,
                                                q_offset=off)
                got = kern()
                err, ratio = _pf_err("flash_attention", got, plain())
                same = bool(torch.equal(got, copied()))
                if not (ratio <= 1.0 and same):
                    raise AssertionError(
                        f"flash_attention on the {label} cache views at a "
                        f"device offset {off}, {dtype}: {err} from its plain "
                        f"version ({ratio:.3g} x the tolerance), "
                        f"{'equal to' if same else 'not equal to'} the "
                        "host-int route over a copy")
                flops, nbytes = D.FA.flash_attention_work(
                    q, k, v, window=w, q_offset=pos)
                op_rate = BF16_RATE if dtype == torch.bfloat16 else F32_RATE
                t_b, t_o = nbytes / rate, flops / op_rate
                i = off + torch.arange(t, device="cuda")
                j = torch.arange(max_seq, device="cuda")
                mask = j[None, :] <= i[:, None]
                if w > 0:
                    mask &= i[:, None] - j[None, :] < w
                rec = {"shape": f"{label} cache view", "dtype":
                       str(dtype)[6:], "q_offset": off, "chunk": t,
                       "window": w, "max_seq": max_seq,
                       "q_offset_on": "device", "max_abs_err": err,
                       "err_over_tol": ratio, "equals_host_int_copy": same,
                       "ms": cuda_ms(kern), "device_ms": device_ms(kern),
                       "plain_ms": cuda_ms(plain, per_group=3, groups=3,
                                           warmup=1),
                       "copy_route_ms": cuda_ms(copied),
                       "bound_ms": 1e3 * max(t_b, t_o),
                       "bound_by": "bytes" if t_b >= t_o else "operations",
                       "flops": flops, "bytes": nbytes,
                       "library_ms": cuda_ms(
                           lambda: F.scaled_dot_product_attention(
                               q, k, v, attn_mask=mask, enable_gqa=True))}
                log(f"    flash_attention on the {label} cache view "
                    f"({max_seq} keys, window {w}), T {t} at device offset "
                    f"{off}, {rec['dtype']}: kernel {rec['ms'] * 1e3:.1f} us "
                    f"(device {rec['device_ms'] * 1e3:.1f}), the replaced "
                    f"copy route {rec['copy_route_ms'] * 1e3:.1f} us, plain "
                    f"{rec['plain_ms'] * 1e3:.1f} us, SDPA "
                    f"{rec['library_ms'] * 1e3:.1f} us, bound "
                    f"{rec['bound_ms'] * 1e3:.1f} us by {rec['bound_by']}, "
                    f"err {err:.3g}, bit-equal to the host-int copy route")
                out.append(rec)
                del q, kc, vc, k, v
    return out


def _dec_counts(D):
    return {"flash_decode": D.FD.launch_count("flash_decode"),
            "flash_decode_paged": D.FD.launch_count("flash_decode_paged"),
            "flash_attention": D.FA.launch_count(),
            "mamba_ssd_scan": D.SSD.launch_count(),
            "wkv6_chunked": D.WKV.launch_count(),
            "plain_attention": D.FD.plain_count() + D.FA.plain_count()}


def _reset_dec_counts(D):
    for mod in (D.FD, D.FA, D.SSD, D.WKV):
        mod.reset_counts()


def _timed_generate(D, cfg, params, prompts, gen, max_seq, **kw):
    """``launch.serve.generate`` (``kw``: its sampling arguments) with a
    CUDA event recorded before and after each of its decode calls
    (``make_decode_step`` wrapped; no sync in the loop) and the host clock
    around the call, ending in a sync.  Returns (tokens, logits, wall s,
    [(T, ms from this call's start to the next one's, or to its own end
    for the last)])."""
    inner = D.serve.make_decode_step
    marks = []

    def make(cfg_, shape=None):
        step = inner(cfg_, shape)

        def timed(params_, cache, tokens, pos):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = step(params_, cache, tokens, pos)
            b.record()
            marks.append((tokens.shape[1], a, b))
            return out
        return timed
    D.serve.make_decode_step = make
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, logits = D.serve.generate(cfg, params, prompts, gen=gen,
                                        max_seq=max_seq, return_logits=True,
                                        **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        D.serve.make_decode_step = inner
    steps = [(t, a.elapsed_time(marks[i + 1][1] if i + 1 < len(marks)
                                else b))
             for i, (t, a, b) in enumerate(marks)]
    return toks, logits, wall, steps


def _check_tokens(arch, toks, logits, cfg, b, n):
    if tuple(toks.shape) != (b, n) or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab_size or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} decode: tokens {tuple(toks.shape)} in "
                             f"[{int(toks.min())}, {int(toks.max())}], "
                             f"finite logits "
                             f"{bool(torch.isfinite(logits).all())}")


def _decode_profile(D, cfg, params, prompts, max_seq):
    """One one-token decode step at the position after the prompts (after
    a chunked prefill of them; the position a 0-d int32 tensor on the
    card, as ``generate`` passes it) under torch.profiler: device busy ms,
    idle share, B5's share and the top kernels."""
    decode = D.serve.make_decode_step(cfg)
    cache = D.models.init_cache(cfg, prompts.shape[0], max_seq,
                                device="cuda")
    logits, cache = decode(params, cache, prompts, 0)
    nxt = logits.argmax(-1)[:, None]
    del logits
    pos = torch.tensor(prompts.shape[1], dtype=torch.int32, device="cuda")
    kern, count, wall = traced_kernels(
        lambda: decode(params, cache, nxt, pos), ("decode_kernel",),
        cfg.n_layers)
    busy = sum(kern.values())
    b5 = sum(us for n, us in kern.items() if "decode_kernel" in n)
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (wall * 1e6),
            "kernel_launches": sum(count.values()),
            "b5_launches": sum(c for n, c in count.items()
                               if "decode_kernel" in n),
            "b5_ms": b5 / 1e3, "b5_share": b5 / busy if busy else 0.0,
            "top_kernels": [{"name": n[:90], "ms": us / 1e3,
                             "share": us / busy} for n, us in top]}


def sampled_generate(D, cfg, params, prompts, n_attn, want, greedy):
    """Phase 21 (b), sampled: ``generate(greedy=False, rng=PRNGKey(0))`` on
    the greedy run's prompts at full width: the greedy run's launches
    (``want``: 32 B4, 32 x 63 B5, no plain attention), bf16 logits, tokens
    in the vocabulary, the prompts kept; the keys ``fold_in(rng, t)`` drawn
    on the card equal the CPU's; bf16 noise on the card equals the CPU's
    bit for bit on all 128 values its uniform takes; the CPU's
    ``categorical`` on the card's logits gives the card's tokens exactly.
    ms a step against the greedy run's."""
    plen, gen = prompts.shape[1], DEC_GEN
    rng = D.prng.PRNGKey(DEC_SAMPLE_SEED, "cuda")
    _reset_dec_counts(D)
    toks, logits, wall, steps = _timed_generate(
        D, cfg, params, prompts, gen, plen + gen, greedy=False, rng=rng)
    got = _dec_counts(D)
    if got != want:
        raise AssertionError(f"sampled static decode: launches {got}, "
                             f"expected {want}")
    _check_tokens("sampled", toks, logits, cfg, DEC_BATCH, plen + gen)
    if not torch.equal(toks[:, :plen], prompts) or \
            logits.dtype != torch.bfloat16:
        raise AssertionError(f"sampled static decode: prompts kept "
                             f"{torch.equal(toks[:, :plen], prompts)}, "
                             f"logits {logits.dtype}")
    t = torch.arange(plen, plen + gen)
    keys = D.prng.fold_in(D.prng.PRNGKey(DEC_SAMPLE_SEED), t)
    if not torch.equal(D.prng.fold_in(rng, t.cuda()).cpu(), keys):
        raise AssertionError("sampled static decode: the keys drawn on the "
                             "card differ from the CPU's")
    bf16, tiny = torch.bfloat16, torch.finfo(torch.bfloat16).tiny
    n_u = len(torch.unique(D.prng.uniform(keys[0].cuda(), (20000,), bf16,
                                          tiny, 1.0).float()))
    g_card = D.prng.gumbel(keys[0].cuda(), (20000,), bf16).cpu()
    if n_u != 128 or not torch.equal(
            g_card.view(torch.int16),
            D.prng.gumbel(keys[0], (20000,), bf16).view(torch.int16)):
        raise AssertionError(f"bf16 noise card vs CPU differs ({n_u} of the "
                             "128 uniforms drawn)")
    lo = logits.cpu()
    picks = torch.stack([D.prng.categorical(keys[i], lo[:, i])
                         for i in range(gen)], dim=1)
    if not torch.equal(picks, toks[:, plen:].cpu().long()):
        raise AssertionError("sampled static decode: the CPU's draw on the "
                             "card's logits gives other tokens")
    step_ms = [ms for _, ms in steps[-(gen - 1):]]
    med = statistics.median(step_ms)
    out = {"seed": DEC_SAMPLE_SEED, "wall_s": wall,
           "tokens_per_s": DEC_BATCH * gen / wall, "ms_per_step": med,
           "ms_per_step_min": min(step_ms), "ms_per_step_max": max(step_ms),
           "greedy_ms_per_step": greedy["ms_per_step"],
           "prefill_ms": steps[0][1], "launches": got}
    log(f"  (b) sampled (key PRNGKey({DEC_SAMPLE_SEED}), bf16 logits): "
        f"{wall:.2f} s, {out['tokens_per_s']:.1f} tokens/s, {med:.2f} ms a "
        f"decode step (greedy {greedy['ms_per_step']:.2f}; min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}); launches {got} as "
        f"the greedy run's; keys and bf16 noise (128 of 128 uniforms) card "
        f"= CPU bit for bit; the CPU's draw on the card's logits gives its "
        f"{DEC_BATCH} x {gen} tokens exactly")
    return out


def decode_phase(D, archs=(DEC_ARCH,) + DEC_SHORT_ARCHS, params=None,
                 prompt=DEC_PROMPT, gen_full=DEC_GEN):
    """Phase 21 (b): ``launch.serve.generate`` at full width in bf16
    (weights from a seeded generator on the card): phi3-mini-3.8b on
    4 x 512 + 64 — exactly 32 B4 launches (the chunked prefill) and 32 x
    63 B5, no plain attention — then zamba2-2.7b (9 B5 launches a step,
    hd 80) and rwkv6-7b (no kernel, no plain attention) on 4 x 32 + 32;
    tokens in the vocabulary and finite logits (phase 22 (c): ``archs``
    granite, on phi3's 4 x 512 + 64; phase 28 (b): gemma3-4b on the
    ``params`` the phase drew, 4 x ``prompt`` + ``gen_full``).  Returns
    (records, launches per kernel)."""
    import numpy as np
    out, launches = {}, {"flash_decode": 0, "flash_attention": 0}
    for arch in archs:
        full = arch not in DEC_SHORT_ARCHS
        plen, gen = (prompt, gen_full) if full else (DEC_SHORT_PROMPT,
                                                     DEC_SHORT_GEN)
        cfg = D.get_config(arch)
        segs = D.layout(cfg)
        n_attn = sum(s.count for s in segs if s.kind in ("attn",
                                                         "shared_attn"))
        t0 = time.perf_counter()
        weights = params or D.models.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prompts = torch.from_numpy(np.random.default_rng(11).integers(
            0, cfg.vocab_size, (DEC_BATCH, plen))).cuda()
        D.serve.generate(cfg, weights, prompts[:, :8], gen=2, max_seq=10)
        torch.cuda.synchronize()                            # warm-up
        torch.cuda.reset_peak_memory_stats()
        _reset_dec_counts(D)
        toks, logits, wall, steps = _timed_generate(
            D, cfg, weights, prompts, gen, plen + gen)
        got = _dec_counts(D)
        peak = torch.cuda.max_memory_allocated()
        n_steps = gen - 1                    # one-token decode steps
        calls = n_steps + (1 if full else plen)
        want = {"flash_decode": n_attn * (calls - (1 if full else 0)),
                "flash_attention": n_attn if full else 0,
                "flash_decode_paged": 0, "mamba_ssd_scan": 0,
                "wkv6_chunked": 0, "plain_attention": 0}
        if got != want:
            raise AssertionError(f"{arch} static decode: launches {got}, "
                                 f"expected {want}")
        _check_tokens(arch, toks, logits, cfg, DEC_BATCH, plen + gen)
        if not torch.equal(toks[:, :plen], prompts):
            raise AssertionError(f"{arch}: generate changed the prompts")
        for k in launches:
            launches[k] += got[k]
        step_ms = [ms for t, ms in steps[-n_steps:]]
        med = statistics.median(step_ms)
        rec = {"params": sum(t.numel() for t in D.tree_leaves(weights)),
               "init_s": init_s, "batch": DEC_BATCH, "prompt": plen,
               "generated": gen, "max_seq": plen + gen,
               "prefill": "chunked" if full else "stepped",
               "wall_s": wall, "tokens_per_s": DEC_BATCH * gen / wall,
               "ms_per_step": med, "ms_per_step_min": min(step_ms),
               "ms_per_step_max": max(step_ms),
               "decode_tokens_per_s": DEC_BATCH / (med / 1e3),
               "launches": got, "peak_bytes": peak}
        if full:
            rec["prefill_ms"] = steps[0][1]
            rec["profile"] = _decode_profile(D, cfg, weights, prompts,
                                             plen + gen)
        else:
            rec["stepped_prefill_ms"] = sum(ms for _, ms in steps[:plen])
        out[arch] = rec
        log(f"static decode: {arch} full width ({rec['params'] / 1e9:.2f} B "
            f"params, bf16), {DEC_BATCH} x {plen} "
            f"({rec['prefill']} prefill) + {gen}: {wall:.2f} s, "
            f"{rec['tokens_per_s']:.1f} generated tokens/s; "
            + (f"prefill {rec['prefill_ms']:.1f} ms, " if full else
               f"stepped prefill {rec['stepped_prefill_ms']:.0f} ms, ")
            + f"{med:.2f} ms a decode step (min {min(step_ms):.2f}, max "
            f"{max(step_ms):.2f}; {rec['decode_tokens_per_s']:.0f} tokens/s "
            f"at batch {DEC_BATCH}); launches {got}; peak "
            f"{peak / 2**30:.2f} GiB")
        if full:
            p = rec["profile"]
            log(f"  profiled decode step at position {plen}: "
                f"{p['wall_ms']:.2f} ms, device busy "
                f"{p['device_busy_ms']:.2f} ms (idle "
                f"{p['device_idle_share']:.1%}), {p['kernel_launches']} "
                f"kernels; B5 {p['b5_launches']} launches, "
                f"{p['b5_ms']:.3f} ms ({p['b5_share']:.1%} of device time)")
            for k in p["top_kernels"]:
                log(f"    {k['ms']:8.3f} ms {k['share']:6.1%}  {k['name']}")
            if not p["b5_share"] > 0:
                raise AssertionError("the profiled decode step finds no "
                                     "time under B5's name")
        if arch == DEC_ARCH:
            rec["sampled"] = sampled_generate(D, cfg, weights, prompts,
                                              n_attn, want, rec)
            for k in launches:
                launches[k] += rec["sampled"]["launches"][k]
        del weights, toks, logits, prompts
        gc.collect()
        torch.cuda.empty_cache()
    return out, launches


def decode_parity_phase(D, archs=DECODE_PARITY_ARCHS, sampled=True):
    """Phase 21 (c): reduced f32 models, ``generate`` on the card against
    the CPU port on the same params and prompts: identical greedy tokens
    and the generated tokens' logits within DECODE_PARITY_BAND; for the
    attention archs also the stepped prefill against the chunked one on
    the card.  Then the static path's tokens against
    ``ServeEngine(backend="paged")`` on the card over PAGED_DRAWS prompt
    draws (reported, not asserted); and (``sampled``) ``sampled_parity``
    (phase 28 (d): gemma3-4b at 6 layers, greedy only)."""
    import numpy as np
    out, threads = {}, torch.get_num_threads()
    plen, gen = DECODE_PARITY_PROMPT, DECODE_PARITY_GEN
    for arch, layers in archs:
        cfg = D.reduced(D.get_config(arch), layers=layers)
        p_cpu = D.models.init_params(cfg, torch.Generator().manual_seed(3),
                                     device="cpu")
        p_card = D.tree_map(lambda t: t.cuda(), p_cpu)
        run = lambda p, tok, **kw: D.serve.generate(
            cfg, p, tok, gen=gen, max_seq=plen + gen, return_logits=True,
            **kw)
        rec = {"layers": layers, "paged_agree": []}
        for draw in range(PAGED_DRAWS if D.serve.chunkable(cfg) else 1):
            tok = torch.from_numpy(np.random.default_rng(5 + draw).integers(
                0, cfg.vocab_size, (2, plen)))
            _reset_dec_counts(D)
            torch.backends.cuda.matmul.allow_tf32 = True  # the step turns
            card_t, card_l = run(p_card, tok.cuda())       # it off itself
            if torch.backends.cuda.matmul.allow_tf32:
                raise AssertionError("the decode step left TF32 on")
            if draw == 0:
                got = _dec_counts(D)
                torch.set_num_threads(1)
                try:
                    cpu_t, cpu_l = run(p_cpu, tok)
                finally:
                    torch.set_num_threads(threads)
                gap = float((card_l.cpu() - cpu_l).abs().max())
                rec.update(logit_gap=gap, logit_max=float(cpu_l.abs().max()),
                           tokens_equal=bool(torch.equal(card_t.cpu(),
                                                         cpu_t)),
                           launches=got)
                attn = any(s.kind in ("attn", "shared_attn")
                           for s in D.layout(cfg))
                if not rec["tokens_equal"] or not gap <= DECODE_PARITY_BAND \
                        or got["plain_attention"] or \
                        attn != bool(got["flash_decode"]):
                    raise AssertionError(
                        f"{arch} reduced decode, card vs CPU: tokens equal "
                        f"{rec['tokens_equal']}, logit gap {gap:.3g} (band "
                        f"{DECODE_PARITY_BAND:g}), launches {got}")
                if D.serve.chunkable(cfg):
                    st_t, st_l = run(p_card, tok.cuda(), stepped_prefill=True)
                    sgap = float((st_l - card_l).abs().max())
                    rec.update(stepped_gap=sgap, stepped_tokens_equal=bool(
                        torch.equal(st_t, card_t)))
                    if not rec["stepped_tokens_equal"] or \
                            not sgap <= DECODE_PARITY_BAND:
                        raise AssertionError(
                            f"{arch} reduced: the stepped prefill gives "
                            f"other tokens or logits {sgap:.3g} apart")
            if D.serve.chunkable(cfg):
                spec = D.PageSpec(page_len=16, pages_per_slot=4, n_slots=2)
                eng = D.ServeEngine(cfg, p_card, spec=spec,
                                    prefill_chunk=16, device="cuda")
                recs = eng.serve([D.Request(rid=i, tokens=tuple(
                    tok[i].tolist()), max_new=gen) for i in range(2)])
                rec["paged_agree"].append(all(
                    r.tokens == card_t[i, plen:].tolist()
                    for i, r in enumerate(recs)))
        out[arch] = rec
        log(f"decode parity {arch} reduced ({layers} layers, f32, {plen} + "
            f"{gen}), card vs CPU: tokens equal, logit gap "
            f"{rec['logit_gap']:.3g} (band {DECODE_PARITY_BAND:g}, logits up "
            f"to {rec['logit_max']:.2f}); launches {rec['launches']}"
            + (f"; stepped vs chunked prefill {rec['stepped_gap']:.3g}; "
               f"static vs paged engine tokens agree in "
               f"{sum(rec['paged_agree'])} of {len(rec['paged_agree'])} "
               "draws" if "stepped_gap" in rec else ""))
    if sampled:
        out["sampled"] = sampled_parity(D)
    return out


def sampled_parity(D):
    """Phase 21 (c), sampled: reduced f32 phi3-mini (2 layers), a sampled
    paged ServeEngine (``PARITY_SAMPLE_KW`` on 4 repetitive requests) and a
    sampled ``generate`` (``PRNGKey(PARITY_SAMPLE_SEED)``) on the card (B6
    and B5 launched) and on the CPU port: the same tokens."""
    import numpy as np
    cfg = D.reduced(D.get_config(DEC_ARCH), layers=2)
    p_cpu = D.models.init_params(cfg, torch.Generator().manual_seed(3),
                                 device="cpu")
    p_card = D.tree_map(lambda t: t.cuda(), p_cpu)
    reqs = D.repetitive_workload(3, 4, vocab=cfg.vocab_size, prompt_len=12,
                                 gen=(8, 14))
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, DECODE_PARITY_PROMPT)))
    gen = DECODE_PARITY_GEN

    def run(params, dev):
        recs = D.ServeEngine(cfg, params, spec=D.PageSpec(
            **PARITY_SAMPLE_SPEC), device=dev, **PARITY_SAMPLE_KW).serve(reqs)
        toks = D.serve.generate(
            cfg, params, tok.to(dev), gen=gen, max_seq=tok.shape[1] + gen,
            greedy=False, rng=D.prng.PRNGKey(PARITY_SAMPLE_SEED, dev))
        return [r.tokens for r in recs], toks.cpu()
    _reset_dec_counts(D)
    card_recs, card_gen = run(p_card, "cuda")
    got = _dec_counts(D)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu_recs, cpu_gen = run(p_cpu, "cpu")
    finally:
        torch.set_num_threads(threads)
    out = {"engine_tokens": sum(len(t) for t in card_recs),
           "engine_equal": card_recs == cpu_recs,
           "generate_equal": bool(torch.equal(card_gen, cpu_gen)),
           "launches": got}
    if not (out["engine_equal"] and out["generate_equal"]) or \
            not got["flash_decode_paged"] or not got["flash_decode"]:
        raise AssertionError(f"sampled parity, reduced {DEC_ARCH}: card vs "
                             f"CPU engine tokens equal {out['engine_equal']},"
                             f" generate tokens equal "
                             f"{out['generate_equal']}; launches {got}")
    log(f"  (c) sampled, reduced {DEC_ARCH} (f32), card vs CPU: the paged "
        f"engine's {out['engine_tokens']} tokens (T "
        f"{PARITY_SAMPLE_KW['temperature']}, top-k "
        f"{PARITY_SAMPLE_KW['top_k']}) and generate's 2 x {gen} equal; "
        f"launches {got}")
    return out


# --------------------------- phase 22: the MoE family -------------------------
# granite-moe-3b-a800m (40 experts, top-8, GQA 24 / 8 heads of 64) at full
# width on every LM path: the prefill (2 x 2048, as phase 15), the static
# decode (4 x 512 + 64, as phase 21), the paged serving engine (phase 12's
# 16 requests) and LM training through the CLI (phase 18's argv, cut from
# 40 steps to 8)
GRANITE_TRAIN_STEPS = 4         # 8 until phase 27 needed the time
GRANITE_TRAIN_ARGV = ["--arch", GRANITE, "--full", "--optimizer", "sgd",
                      "--scheme", "hybrid", "--seq", "128", "--global-batch",
                      "16", "--lr", "5e-3", "--steps", str(GRANITE_TRAIN_STEPS)]
GRANITE_SERVE_LEGS = ("paged_recorded", "paged")
GRANITE_SERVE_LAYERS = 8        # of 32: all 32 until phase 25's serving
# card vs CPU: reduced granite that keeps n_rep 3 at hd 64 (6 / 2 heads),
# 4 experts, top-2, f32
GRANITE_REDUCED = dict(d_model=384, n_heads=6)
# routing is discontinuous: where the two devices rank a token's experts
# differently, the card's gates at the first rank that differs must lie
# within this of the next rank's (a near-tie, rounding's reach: the two
# devices' f32 probabilities differ by about 1e-7); the CPU legs then run
# on the card's choices (``RouteSides``), as phase 5 runs on its ReLU sides
ROUTE_TIE = 1e-5
# the MoE layer's einsums by part, for the prefill's split
MOE_EINSUMS = {"ngd,ngec->necd": "moe: dispatch / combine einsums",
               "necd,ngec->ngd": "moe: dispatch / combine einsums",
               "necd,edf->necf": "moe: expert einsums",
               "necf,efd->necd": "moe: expert einsums"}


def _moe_split(P, prefill, params, tokens, tries: int = 3):
    """One prefill under ``torch.profiler`` (host and device activity) with
    the MoE layer's parts marked by ``record_function`` ranges: the device
    time under each — the router (its f32 product and softmax), the
    routing (the choices, and the dispatch and combine tensors built from
    them), the dispatch / combine einsums, the expert einsums, and the rest
    of the layer (the SiLU gate, casts) — and the layer's share of the
    prefill's device time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    moe, tf = P.moe, P.transformer

    def marked(label, fn):
        def call(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return call

    class Torch:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def einsum(eq, *ops):
            if eq not in MOE_EINSUMS:
                return torch.einsum(eq, *ops)
            with record_function(MOE_EINSUMS[eq]):
                return torch.einsum(eq, *ops)
    saved = (moe.router_probs, moe.top_k_choices, moe.dispatch_tensors,
             moe.torch, tf.moe_ffn)
    moe.router_probs = marked("moe: router", saved[0])
    moe.top_k_choices = marked("moe: routing", saved[1])
    moe.dispatch_tensors = marked("moe: routing", saved[2])
    moe.torch, tf.moe_ffn = Torch(), marked("moe: layer", saved[4])
    cuda = torch.autograd.DeviceType.CUDA
    try:
        for _ in range(tries):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                prefill(params, tokens)
                torch.cuda.synchronize()
            events = prof.events()
            # the ranges' device-side spans ("gpu_user_annotation", named
            # as the ranges) are no kernels
            busy = sum(ev.time_range.elapsed_us() for ev in events
                       if ev.device_type == cuda and
                       not ev.name.startswith("moe: "))
            if busy:
                break
    finally:
        (moe.router_probs, moe.top_k_choices, moe.dispatch_tensors,
         moe.torch, tf.moe_ffn) = saved
    parts = {}
    for ev in events:
        if ev.device_type != cuda and ev.name.startswith("moe: "):
            dev = getattr(ev, "device_time_total", None)
            if dev is None:
                dev = ev.cuda_time_total
            parts[ev.name] = parts.get(ev.name, 0.0) + dev
    layer = parts.pop("moe: layer", 0.0)
    parts["moe: rest of the layer"] = layer - sum(parts.values())
    out = {"device_busy_ms": busy / 1e3, "moe_ms": layer / 1e3,
           "moe_share": layer / busy if busy else 0.0,
           "parts": {k[5:]: {"ms": us / 1e3,
                             "share_of_moe": us / layer if layer else 0.0,
                             "share_of_prefill": us / busy if busy else 0.0}
                     for k, us in parts.items()}}
    log(f"  the MoE layer in one profiled prefill: {out['moe_ms']:.2f} ms of "
        f"{out['device_busy_ms']:.2f} ms device time "
        f"({out['moe_share']:.1%}); " + ", ".join(
            f"{k} {v['ms']:.2f} ms ({v['share_of_moe']:.1%})"
            for k, v in out["parts"].items()))
    if not 0 < layer <= busy:
        raise AssertionError(f"the profiled prefill finds {layer} us of "
                             f"device time under the MoE layer's range, of "
                             f"{busy} us")
    return out


class RouteSides:
    """The experts every router call of ``models.moe`` chose in one run
    (``record``: each call's f32 probabilities and ranked top-k indices),
    and a later run that takes the recorded choices (``replay``: the
    recorded indices, their gates read from the run's own probabilities),
    so that two runs differ by their rounding alone — phase 5's
    ``ReluSides`` for the MoE router's discontinuity.  ``flips`` compares
    two recorded runs."""

    def __init__(self):
        self.calls, self.replayed = [], 0

    def record(self, moe, run):
        real = moe.top_k_choices

        def choices(probs, top_k):
            vals, idx = real(probs, top_k)
            self.calls.append((probs.detach().float().cpu(),
                               idx.detach().cpu()))
            return vals, idx
        moe.top_k_choices = choices
        try:
            return run()
        finally:
            moe.top_k_choices = real

    def replay(self, moe, run):
        real, self.replayed = moe.top_k_choices, 0

        def choices(probs, top_k):
            if self.replayed == len(self.calls):
                raise AssertionError("the replayed run routes more often "
                                     "than the recorded run did")
            idx = self.calls[self.replayed][1].to(probs.device)
            if tuple(idx.shape) != tuple(probs.shape[:-1]) + (top_k,):
                raise AssertionError(f"router call {self.replayed}: "
                                     f"recorded {tuple(idx.shape)}, now "
                                     f"{tuple(probs.shape)} top {top_k}")
            self.replayed += 1
            return probs.gather(-1, idx), idx
        moe.top_k_choices = choices
        try:
            out = run()
        finally:
            moe.top_k_choices = real
        if self.replayed != len(self.calls):
            raise AssertionError(f"the replayed run routed {self.replayed} "
                                 f"times, the recorded one "
                                 f"{len(self.calls)}")
        return out

    def flips(self, other):
        """This run's choices against ``other``'s, call by call up to the
        first call where a token's ranked choices differ (later calls see
        inputs that the flip moved): the calls compared, the tokens that
        differ there, and the widest of their margins (this run's gate at
        the first rank that differs less the next rank's)."""
        out = {"calls": len(self.calls), "compared": 0, "first_flip": None,
               "flipped_tokens": 0, "max_flip_margin": 0.0}
        for i, ((p, a), (_, b)) in enumerate(zip(self.calls, other.calls)):
            if a.shape != b.shape:
                raise AssertionError(f"router call {i}: {tuple(a.shape)} "
                                     f"against {tuple(b.shape)}")
            out["compared"] = i + 1
            diff = (a != b).any(-1).reshape(-1)
            if not bool(diff.any()):
                continue
            pr = p.reshape(-1, p.shape[-1])[diff]
            ar, br = a.reshape(-1, a.shape[-1])[diff], \
                b.reshape(-1, b.shape[-1])[diff]
            srt = torch.sort(pr, dim=-1, descending=True).values
            rank = (ar != br).int().argmax(-1)
            margin = srt.gather(-1, rank[:, None]) - \
                srt.gather(-1, rank[:, None] + 1)
            out.update(first_flip=i, flipped_tokens=int(diff.sum()),
                       max_flip_margin=float(margin.max()))
            break
        return out


def _token_major_dispatch(gate_vals, gate_idx, n_experts, capacity):
    """A planted fault in ``moe.dispatch_tensors``: the choices queue for
    capacity token by token (each token's k choices together) instead of
    k-major, which changes the choices a full expert drops."""
    *lead, g, k = gate_idx.shape
    dev = gate_idx.device
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    flat = (gate_idx[..., None] == torch.arange(n_experts, device=dev)) \
        .float().reshape(*lead, g * k, n_experts)
    pos = torch.sum((torch.cumsum(flat, dim=-2) - flat) * flat, dim=-1)
    within = pos < capacity
    slot = torch.where(within, pos, torch.zeros_like(pos)).long()
    cap = (slot[..., None] == torch.arange(capacity, device=dev)).float() \
        * within[..., None]
    both = flat[..., :, None] * cap[..., None, :]
    disp = both.reshape(*lead, g, k, n_experts, capacity).sum(dim=-3)
    comb = (both * gate_vals.reshape(*lead, g * k)[..., None, None]) \
        .reshape(*lead, g, k, n_experts, capacity).sum(dim=-3)
    return disp, comb


def _dropped(moe, sides, capacity):
    """Choices a recorded run's dispatch dropped, over all its calls."""
    n = 0
    for probs, idx in sides.calls:
        disp, _ = moe.dispatch_tensors(probs.gather(-1, idx), idx,
                                       probs.shape[-1], capacity)
        n += idx.numel() - int(disp.sum())
    return n


def _cpu(fn):
    """``fn()`` on one CPU thread (ROADMAP C5), as the CPU tests run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def _routed_pair(M, card_run, cpu_run, label):
    """The card run recorded, the CPU run free (recorded) and again on the
    card's choices: (card result, CPU result on the card's choices, free
    CPU result, the card's ``RouteSides``, the routes' comparison).  Where
    the free CPU run ranks a token's experts otherwise, that must be a
    near-tie of the card's gates.  ``card_run`` reads its launch counts
    itself: the CPU legs count plain runs."""
    card_sides, cpu_sides = RouteSides(), RouteSides()
    card = card_sides.record(M.moe, card_run)
    free = _cpu(lambda: cpu_sides.record(M.moe, cpu_run))
    cpu = _cpu(lambda: card_sides.replay(M.moe, cpu_run))
    flips = card_sides.flips(cpu_sides)
    if flips["first_flip"] is not None and \
            not flips["max_flip_margin"] <= ROUTE_TIE:
        raise AssertionError(f"{label}: the card and the CPU route a token "
                             f"otherwise beyond a near-tie: {flips}")
    return card, cpu, free, card_sides, flips


def moe_parity_phase(M):
    """Phase 22 (f): reduced f32 granite (6 / 2 heads of 64, n_rep 3; 4
    experts, top-2) on the card against the CPU port, each CPU leg on the
    card's expert choices after the free CPU run's choices were compared
    with them (``_routed_pair``): the prefill's last-position logits within
    PREFILL_PARITY_BAND; ``generate`` tokens identical and logits within
    DECODE_PARITY_BAND; the paged engine's tokens identical and logits
    within SERVE_PARITY_BAND; 4 fused dual-batch steps within
    TRAIN_PARITY_BAND.  The prefill's capacity (1.25 x 2 x 90 / 4 = 56
    slots an expert) drops choices, and there a planted fault, token-major
    capacity queues on the card, must land outside the prefill band."""
    import numpy as np
    cfg = M.reduced(M.get_config(GRANITE), **GRANITE_REDUCED)
    p_cpu = M.models.init_params(cfg, torch.Generator().manual_seed(3),
                                 device="cpu")
    p_card = M.tree_map(lambda t: t.cuda(), p_cpu)
    out = {"heads": (cfg.n_heads, cfg.n_kv_heads), "head_dim": cfg.head_dim,
           "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k}

    # the prefill, and the planted fault
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, PREFILL_PARITY_SEQ)))
    prefill = M.make_prefill_step(cfg)

    def card_prefill():
        M.reset_counts()
        logits = prefill(p_card, tok.cuda()).cpu()
        return logits, M.counts()
    (card, counts), cpu, free, sides, flips = _routed_pair(
        M, card_prefill, lambda: prefill(p_cpu, tok),
        f"prefill (reduced {GRANITE})")
    b4 = counts["launches"]["flash_attention"]
    moe_cfg = cfg.moe
    capacity = max(moe_cfg.top_k, int(moe_cfg.capacity_factor * moe_cfg.top_k
                                      * tok.numel() / moe_cfg.num_experts))
    gap = float((card - cpu).abs().max())
    rec = out["prefill"] = {
        "logit_gap": gap, "free_logit_gap": float((card - free).abs().max()),
        "logit_max": float(cpu.abs().max()), "capacity": capacity,
        "dropped": _dropped(M.moe, sides, capacity), "routes": flips,
        "b4_launches": b4}
    log(f"MoE parity, prefill (reduced {GRANITE}, f32, 2 x "
        f"{PREFILL_PARITY_SEQ}, capacity {capacity}, {rec['dropped']} "
        f"choices dropped), card vs CPU on the card's choices: logit gap "
        f"{gap:.3g} (band {PREFILL_PARITY_BAND:g}); free CPU run "
        f"{rec['free_logit_gap']:.3g}, routes {flips}; {b4} B4 launches")
    if not gap <= PREFILL_PARITY_BAND or b4 != cfg.n_layers or \
            counts["plain"]:
        raise AssertionError(f"prefill: the card and the CPU port disagree "
                             f"({gap}) or B4 ran {b4} times")
    if not rec["dropped"]:
        raise AssertionError("the prefill's capacity drops nothing: the "
                             "planted fault would not show")
    faulty = RouteSides()
    saved, M.moe.dispatch_tensors = M.moe.dispatch_tensors, \
        _token_major_dispatch
    try:
        bad = faulty.record(M.moe, lambda: prefill(p_card, tok.cuda()).cpu())
    finally:
        M.moe.dispatch_tensors = saved
    ref = _cpu(lambda: faulty.replay(M.moe, lambda: prefill(p_cpu, tok)))
    fgap = float((bad - ref).abs().max())
    out["planted_token_major"] = {"logit_gap": fgap,
                                  "inside_band": fgap <= PREFILL_PARITY_BAND}
    log(f"  planted fault (token-major capacity queues), card vs CPU on the "
        f"card's choices: logit gap {fgap:.3g}: "
        f"{'inside' if fgap <= PREFILL_PARITY_BAND else 'outside'} the band")
    if fgap <= PREFILL_PARITY_BAND:
        raise AssertionError("the planted token-major fault lands inside the "
                             "prefill band")

    # generate: dropless decode steps
    plen, gen = DECODE_PARITY_PROMPT, DECODE_PARITY_GEN
    prompts = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, plen)))
    run = lambda p, t: M.serve.generate(cfg, p, t, gen=gen, max_seq=plen + gen,
                                        return_logits=True)

    def card_generate():
        for mod in (M.FA, M.FD):
            mod.reset_counts()
        res = run(p_card, prompts.cuda())
        return res, {"flash_attention": M.FA.launch_count(),
                     "flash_decode": M.FD.launch_count("flash_decode"),
                     "plain": M.FA.plain_count() + M.FD.plain_count()}
    ((ct, cl), launches), (pt, pl), (ft, _), _, flips = _routed_pair(
        M, card_generate, lambda: run(p_cpu, prompts),
        f"generate (reduced {GRANITE})")
    gap = float((cl.cpu() - pl).abs().max())
    same = bool(torch.equal(ct.cpu(), pt))
    out["generate"] = {"tokens_equal": same, "free_tokens_equal": bool(
        torch.equal(ct.cpu(), ft)), "logit_gap": gap, "routes": flips,
        "launches": launches}
    log(f"MoE parity, generate (reduced {GRANITE}, {plen} + {gen}), card vs "
        f"CPU on the card's choices: tokens equal {same}, logit gap "
        f"{gap:.3g} (band {DECODE_PARITY_BAND:g}); free CPU tokens equal "
        f"{out['generate']['free_tokens_equal']}, routes {flips}; launches "
        f"{launches}")
    want = {"flash_attention": cfg.n_layers,
            "flash_decode": cfg.n_layers * (gen - 1), "plain": 0}
    if not same or not gap <= DECODE_PARITY_BAND or launches != want:
        raise AssertionError(f"generate: the card and the CPU port disagree, "
                             f"or launches {launches} != {want}")

    # the paged engine on the churn workload of phase 13
    spec = M.PageSpec(page_len=16, pages_per_slot=4, n_slots=2)
    reqs = M.synthetic_workload(1, 8, vocab=cfg.vocab_size,
                                prompt_lens=(3, 20), gen_short=(3, 8),
                                gen_long=(12, 20), p_long=0.3)
    serve = lambda p, device: M.ServeEngine(
        cfg, p, spec=spec, prefill_chunk=8, record_logits=True,
        device=device)

    def card_serve():
        M.FD.reset_counts()
        eng = serve(p_card, "cuda")
        recs = eng.serve(reqs)
        return recs, (M.FD.launch_count("flash_decode_paged"),
                      M.FD.plain_count(), eng.stats["decode_calls"])
    (rc, (b6, plain, calls)), rp, rf, _, flips = _routed_pair(
        M, card_serve, lambda: serve(p_cpu, "cpu").serve(reqs),
        f"paged engine (reduced {GRANITE})")
    same = all(a.tokens == b.tokens for a, b in zip(rc, rp))
    gap = max(float(np.abs(x - y).max()) for a, b in zip(rc, rp)
              for x, y in zip(a.logits, b.logits))
    out["serve"] = {"tokens_equal": same, "free_tokens_equal": all(
        a.tokens == b.tokens for a, b in zip(rc, rf)), "logit_gap": gap,
        "routes": flips, "b6_launches": b6, "decode_calls": calls}
    log(f"MoE parity, paged engine (reduced {GRANITE}, churn workload), card "
        f"vs CPU on the card's choices: tokens identical {same}, logit gap "
        f"{gap:.3g} (band {SERVE_PARITY_BAND:g}); free CPU tokens identical "
        f"{out['serve']['free_tokens_equal']}, routes {flips}; {b6} B6 "
        f"launches ({cfg.n_layers} x {calls} decode ticks)")
    if not same or not gap <= SERVE_PARITY_BAND or \
            b6 != cfg.n_layers * calls or plain:
        raise AssertionError("paged engine: the card and the CPU port "
                             "disagree, or B6 did not run every tick")

    # training: fused dual-batch SGD steps (B1 a step on the card)
    steps = TRAIN_PARITY_ARGS["steps"]
    (card, cc), (cpu, _), (free, _), _, flips = _routed_pair(
        M, lambda: _train_run(M, cfg, p_cpu, "fused", "cuda"),
        lambda: _train_run(M, cfg, p_cpu, "fused", "cpu"),
        f"training (reduced {GRANITE})")
    lc = [h["loss"] for h in card.history]
    lp = [h["loss"] for h in cpu.history]
    rec = {"loss_gap": max(abs(a - b) for a, b in zip(lc, lp)),
           "param_gap": _leaf_gaps(M.tree_leaves(card.params),
                                   M.tree_leaves(cpu.params)),
           "free_loss_gap": max(abs(a - h["loss"]) for a, h in
                                zip(lc, free.history)),
           "losses": lc, "routes": flips,
           "launches": cc["dbl"]["dbl_apply_flat2d"]}
    out["train"] = rec
    log(f"MoE parity, training (reduced {GRANITE}, {steps} fused dual-batch "
        f"steps), card vs CPU on the card's choices: loss gap "
        f"{rec['loss_gap']:.3g}, param gap {rec['param_gap']:.3g} (bands "
        f"{TRAIN_PARITY_BAND['loss']:g} / {TRAIN_PARITY_BAND['params']:g}); "
        f"free CPU loss gap {rec['free_loss_gap']:.3g}, routes {flips}; "
        f"{rec['launches']} dbl_apply_flat2d launches")
    if not (len(lc) == len(lp) == steps and
            rec["loss_gap"] <= TRAIN_PARITY_BAND["loss"] and
            rec["param_gap"] <= TRAIN_PARITY_BAND["params"] and
            rec["launches"] == steps and not cc["dbl_plain"]):
        raise AssertionError(f"training: the card and the CPU port disagree "
                             f"beyond {TRAIN_PARITY_BAND}: {rec}")
    return out


def moe_phase(M, rate):
    """Phase 22: granite-moe-3b-a800m at full width on every LM path (the
    kernels at its geometry, (a), ran in phases 11, 14 and 21): (b) the
    prefill with the MoE layer's split, (c) the static decode, (d) the
    paged serving engine, (e) LM training through the CLI; then (f) card
    vs CPU.  Returns (records, launches per kernel on the four paths, B1's
    record at granite's store)."""
    from dataclasses import replace
    out, launches = {}, {}
    gc.collect()
    torch.cuda.empty_cache()
    out["prefill"], pf = prefill_phase(M, archs=(GRANITE,))
    out["decode"], dl = decode_phase(M, archs=(GRANITE,))
    launches["flash_attention"] = pf["flash_attention"] + \
        dl["flash_attention"]
    launches["flash_decode"] = dl["flash_decode"]
    out["serving"], sl = serving_phase(
        M, GRANITE, legs=GRANITE_SERVE_LEGS,
        cfg=replace(M.get_config(GRANITE), n_layers=GRANITE_SERVE_LAYERS))
    launches["flash_decode_paged"] = sum(sl["flash_decode_paged"].values())
    gc.collect()
    torch.cuda.empty_cache()
    out["lm_train"], b1 = lm_train_phase(M, rate, GRANITE,
                                         GRANITE_TRAIN_ARGV,
                                         GRANITE_TRAIN_STEPS)
    launches["dbl_apply_flat2d"] = \
        out["lm_train"]["launches"]["dbl_apply_flat2d"]
    out["parity"] = moe_parity_phase(M)
    launches["dbl_apply_flat2d"] += out["parity"]["train"]["launches"]
    return out, launches, b1


# ------------------------------ phase 23: SPMD -------------------------------
SPMD_ARCH = "phi3-mini-3.8b"
SPMD_STEPS = 6                  # fused SGD (10 until phase 27 needed the time)
SPMD_WEIGHTED_STEPS = 4         # the example's own form
# the weighted form (sgd_momentum's functional update holds params,
# gradients, velocity and the new params and velocity at once: 5 x 15.3
# GB at 32 layers) and the no-mesh per-step fused run (params, both
# group gradients and their three raveled copies at its B2 launch: 6 x
# 15.3 GB) fit the card only at cut depth; full width, 4 of 32 layers
# (16 until phase 26 needed the time, 8 until phase 27 did)
SPMD_CUT_LAYERS = 4
SPMD_CPU_RANKS, SPMD_CPU_MESH = 4, (2, 2)
SPMD_PARITY_STEPS = 4
SPMD_TIMEOUT_S = 300
B2_NAME = "dbl_merge_flat2d"


def _host_gib() -> float:
    """This process's resident host memory, GiB."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30


def _spmd_counts(Z):
    return {"b2": Z.K.launch_count(B2_NAME), "b1":
            Z.K.launch_count("dbl_apply_flat2d"), "all": Z.K.launch_count(),
            "plain": Z.K.plain_count()}


def b2_leafwise_phase(Z, mesh, rate):
    """Phase 23 (a): B2's leafwise form on a full-width phi3-mini tree of
    DTensors (the leaves are views of one seeded N(0, 1) flat store, so
    the flat form runs on the same numbers): one launch per leaf, the
    live region bit-equal to the flat one-launch form and to the plain
    version (a slice at a time); timed beside the flat form, the plain
    version leaf by leaf and the bytes bound."""
    # the store's geometry from a model built on the card and freed
    params = Z.models.init_params(
        replace_f32(Z.get_config(SPMD_ARCH)),
        torch.Generator(device="cuda").manual_seed(0), device="cuda")
    spec = Z.flat_spec(params)
    del params
    torch.cuda.empty_cache()
    n, leaves = spec.n, len(spec.sizes)
    gen = torch.Generator(device="cuda").manual_seed(23)
    bufs = []
    for _ in range(3):
        b = torch.randn(spec.shape, generator=gen, device="cuda")
        b.view(-1)[n:] = 0.0
        bufs.append(b)
    p2, gl2, gs2 = bufs
    flat = p2.clone()
    Z.K.reset_counts()
    Z.K.dbl_merge_flat2d(flat, gl2, gs2, factor=FACTOR, lr=LR)
    for r0 in range(0, spec.rows, PLAIN_SLICE_ROWS):
        sl = slice(r0, r0 + PLAIN_SLICE_ROWS)
        ref = Z.K.dbl_merge_plain(p2[sl].clone(), gl2[sl], gs2[sl],
                                  factor=FACTOR, lr=LR)
        if not torch.equal(ref, flat[sl]):
            raise AssertionError(f"B2 flat form differs from its plain "
                                 f"version at rows {r0}..")
        del ref
    trees = [spec.unravel(b) for b in bufs]
    specs = Z.param_specs(trees[0], mesh)
    trees = [Z.distribute_tree(t, specs, mesh) for t in trees]
    Z.K.reset_counts()
    Z.ops.dbl_merge(*trees, factor=FACTOR, lr=LR, leafwise=True)
    torch.cuda.synchronize()
    got = _spmd_counts(Z)
    if got["b2"] != leaves or got["all"] != leaves or got["plain"]:
        raise AssertionError(f"leafwise dbl_merge: {got}, expected one "
                             f"{B2_NAME} launch per leaf ({leaves})")
    if not all(isinstance(t, Z.DTensor) for t in Z.tree_leaves(trees[0])):
        raise AssertionError("leafwise tree lost its DTensors")
    if not torch.equal(p2.view(-1)[:n], flat.view(-1)[:n]):
        gap = float((p2.view(-1)[:n] - flat.view(-1)[:n]).abs().max())
        raise AssertionError(f"leafwise B2 differs from the flat form by "
                             f"{gap}")
    leafwise = lambda: Z.ops.dbl_merge(*trees, factor=FACTOR, lr=LR,
                                       leafwise=True)
    ms = cuda_ms(leafwise, per_group=3, groups=5, warmup=1)
    flat_ms = cuda_ms(lambda: Z.K.dbl_merge_flat2d(flat, gl2, gs2,
                                                   factor=FACTOR, lr=LR),
                      per_group=3, groups=5, warmup=1)
    del flat
    torch.cuda.empty_cache()
    leaf_sets = list(zip(*(Z.tree_leaves(spec.unravel(b)) for b in bufs)))

    def plain_leafwise():
        for w, a, b in leaf_sets:
            Z.K.dbl_merge_plain(w.view(-1, 128), a.view(-1, 128),
                                b.view(-1, 128), factor=FACTOR, lr=LR)
    plain_ms = cuda_ms(plain_leafwise, per_group=1, groups=3, warmup=1)
    nbytes = B2["plain"][1] * n
    bound_ms = max(nbytes / rate, B2["plain"][2] * n / F32_RATE) * 1e3
    rec = {"variant": "leafwise", "replaces":
           f"{REFERENCE}:{KERNEL_INFO[B2_NAME][0]}", "shape": SPMD_ARCH,
           "leaves": leaves, "elements": n, "max_abs_err": 0.0, "ms": ms,
           "flat_ms": flat_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes" if nbytes / rate >= B2["plain"][2] * n
           / F32_RATE else "operations", "library_ms": None,
           "bytes": nbytes}
    log(f"B2 leafwise on full-width {SPMD_ARCH} ({leaves} DTensor leaves, "
        f"{n} elements): {leaves} launches, bit-equal to the flat form and "
        f"the plain version; {ms:.2f} ms a tree (the sum over leaves), flat "
        f"form {flat_ms:.2f} ms, plain leaf by leaf {plain_ms:.2f} ms, bound "
        f"{bound_ms:.2f} ms ({bound_ms / ms:.0%} of the memory roofline)")
    del trees, leaf_sets, bufs, p2, gl2, gs2
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def replace_f32(cfg, **kw):
    """``cfg`` with f32 params and compute (the fused B2 path's store)."""
    from dataclasses import replace
    return replace(cfg, param_dtype="float32", compute_dtype="float32", **kw)


def _spmd_run(Z, cfg, mesh, params, *, form, steps, device="cuda"):
    """The example's schedule on ``mesh`` (or without one on the card):
    ``form`` "fused" (sgd, fused_merge=True; per-step loop without a
    mesh) or "weighted" (the example's own: sgd_momentum(0.9), auto).
    Returns (RunResult, counts, wall seconds, peak bytes)."""
    kw = (dict(optimizer=Z.sgd_momentum(0.0), fused_merge=True)
          if form == "fused" else dict(optimizer=Z.sgd_momentum(0.9)))
    if mesh is None and form == "fused":
        kw["scan_loop"] = False
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    Z.K.reset_counts()
    t0 = time.perf_counter()

    def progress(rec):
        log(f"    step {rec['step']}: loss {rec['loss']}, "
            f"{time.perf_counter() - t0:.1f} s, host {_host_gib():.1f} GiB, "
            f"card {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    res = Z.ex.run_example(cfg, mesh, device=None if mesh else device,
                           params=params, n_steps=steps, log_every=1,
                           log_fn=progress, **kw)
    torch.cuda.synchronize()
    return res, _spmd_counts(Z), time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated()


def _run_record(Z, cfg, res, counts, wall, peak, steps):
    losses = [h["loss"] for h in res.history]
    p = res.phases[0]
    tokens = Z.ex.example_phases(steps)[0].layout.effective_examples \
        * Z.ex.SEQ
    return {"losses": losses, "launches": counts, "wall_s": wall,
            "peak_bytes": peak, "phase_s": p["time"],
            "ms_per_step": 1e3 * p["time"] / steps,
            "tokens_per_s": tokens * steps / p["time"]}


def _host_leaves(Z, tree):
    return [(t.full_tensor() if isinstance(t, Z.DTensor) else t)
            .detach().cpu() for t in Z.tree_leaves(tree)]


def _spmd_profile(Z, cfg, mesh, params):
    """One fused mesh step of the example's phase under the profiler:
    device busy and idle share, B2's share, top kernels; CUDA-event ms of
    the step (median of 3)."""
    phase = Z.ex.example_phases(1)[0]
    engine = Z.TrainEngine(cfg, Z.sgd_momentum(0.0), mesh=mesh,
                           fused_merge=True)
    plane = Z.ex.example_plane(cfg)
    plane.bind([phase])
    batch = {k: torch.as_tensor(v).cuda() for k, v in plane(phase, 0).items()}
    plane.close()
    step, _ = engine.step_fn(phase)
    state = [params, None]

    def run():
        state[0], _, _ = engine._mesh_step(step, phase, state[0], None,
                                           batch, None)
    run()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    step_ms = statistics.median(times)
    # a window that dropped any of the step's B2 launches is traced again
    kern, count, _ = traced_kernels(run, ("dbl_sweep",),
                                    len(Z.tree_leaves(params)))
    busy = sum(kern.values()) / 1e3
    b2 = sum(us for k, us in kern.items() if "dbl_sweep" in k) / 1e3
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
    return {"step_ms": step_ms, "step_ms_runs": times,
            "device_busy_ms": busy, "device_idle_share": 1.0 - busy / step_ms,
            "b2_ms": b2, "b2_share": b2 / busy if busy else 0.0,
            "b2_launches": sum(c for k, c in count.items()
                               if "dbl_sweep" in k),
            "kernel_launches": sum(count.values()),
            "top_kernels": [{"name": k[:90], "ms": us / 1e3,
                             "share": us / 1e3 / busy} for k, us in top]}


def _gloo_rank(rank, world, init, work):
    """One CPU rank of phase 23 (d): the example's fused schedule on a
    gloo mesh, run free and then with per-rank denominators planted in
    the weighted loss.  Rank 0 saves each run's losses and full params."""
    import datetime
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world, timeout=datetime.timedelta(
                                seconds=SPMD_TIMEOUT_S))
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.core.tree import tree_leaves
        from repro_torch.examples import dual_batch_spmd as ex
        from repro_torch.models import transformer
        from repro_torch.optim import sgd_momentum
        mesh = init_device_mesh("cpu", SPMD_CPU_MESH,
                                mesh_dim_names=("data", "model"))
        free = transformer.loss_fn
        for fault in (False, True):
            inp = torch.load(os.path.join(work, "inputs.pt"),
                             weights_only=False)
            transformer.loss_fn = _per_rank_denominators(free) if fault \
                else free
            res = ex.run_example(inp["cfg"], mesh, params=inp["params"],
                                 optimizer=sgd_momentum(0.0),
                                 fused_merge=True,
                                 n_steps=SPMD_PARITY_STEPS, log_every=1)
            full = [t.full_tensor() for t in tree_leaves(res.params)]
            if rank == 0:
                torch.save({"losses": [h["loss"] for h in res.history],
                            "params": full},
                           os.path.join(work, f"cpu_{int(fault)}.pt"))
        transformer.loss_fn = free
    finally:
        dist.destroy_process_group()


def _per_rank_denominators(loss_fn):
    """The planted fault: the weighted loss over the rank's own rows in
    the denominator (``sum(w)`` of the local shard)."""
    def faulty(params, cfg, batch, **kw):
        _, aux = loss_fn(params, cfg, batch, **kw)
        per_ex = aux["per_example"]
        w = batch.get("weight")
        if w is None:
            w = torch.ones_like(per_ex)
        loss = torch.sum(per_ex * w) / w.to_local().sum()
        return loss, {"loss": loss, "per_example": per_ex}
    return faulty


def _cpu_mesh_runs(cfg, params):
    """Phase 23 (d)'s CPU legs: the gloo ranks spawned once (two spawns,
    free and then with the planted fault, until phase 25's serving needed
    the time), with a timeout."""
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as work:
        torch.save({"cfg": cfg, "params": params},
                   os.path.join(work, "inputs.pt"))
        init = "file://" + os.path.join(work, "pg")
        ctx = mp.start_processes(
            _gloo_rank, args=(SPMD_CPU_RANKS, init, work),
            nprocs=SPMD_CPU_RANKS, start_method="spawn", join=False)
        deadline = time.time() + SPMD_TIMEOUT_S
        try:
            while not ctx.join(timeout=1):
                if time.time() > deadline:
                    raise TimeoutError("gloo ranks of phase 23 (d) "
                                       "outlived their timeout")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return {fault: torch.load(os.path.join(work, f"cpu_{int(fault)}.pt"),
                                  weights_only=False)
                for fault in (False, True)}


def _spmd_names():
    """What phase 23 uses of the port, imported once CUDA is known."""
    from types import SimpleNamespace
    from torch.distributed.tensor import DTensor
    from repro_torch import models
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.flat import flat_spec
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.engine import TrainEngine
    from repro_torch.examples import dual_batch_spmd as ex
    from repro_torch.kernels import dbl_merge as K
    from repro_torch.kernels import ops
    from repro_torch.launch.sharding import distribute_tree, param_specs
    from repro_torch.optim import sgd_momentum
    return SimpleNamespace(DTensor=DTensor, models=models,
                           get_config=get_config, reduced=reduced,
                           flat_spec=flat_spec, tree_leaves=tree_leaves,
                           tree_map=tree_map, TrainEngine=TrainEngine, ex=ex,
                           K=K, ops=ops, distribute_tree=distribute_tree,
                           param_specs=param_specs, sgd_momentum=sgd_momentum)


def spmd_phase(Z, rate):
    """Phase 23: multi-GPU SPMD on one NCCL rank, mesh (1, 1) named
    ("data", "model").  Returns (record, B2's leafwise record, the
    leafwise launches of the runs on the card)."""
    import datetime
    import tempfile
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl", init_method="file://" + os.path.join(tmp, "pg"), rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=SPMD_TIMEOUT_S))
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            rec = b2_leafwise_phase(Z, mesh, rate)
            launches = 0
            # (b) the main path: full width and depth, fused, 10 steps
            log(f"  (b) full-width mesh run (host {_host_gib():.1f} GiB)")
            cfg = replace_f32(Z.get_config(SPMD_ARCH))
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = Z.models.init_params(cfg, gen, device="cuda")
            params = Z.distribute_tree(params, Z.param_specs(params, mesh),
                                       mesh)
            res, cnt, wall, peak = _spmd_run(Z, cfg, mesh, params,
                                             form="fused", steps=SPMD_STEPS)
            leaves = len(Z.tree_leaves(res.params))
            main = _run_record(Z, cfg, res, cnt, wall, peak, SPMD_STEPS)
            log(f"  (b) ran; profiling a step (host {_host_gib():.1f} GiB)")
            losses = main["losses"]
            if cnt["b2"] != leaves * SPMD_STEPS or cnt["all"] != cnt["b2"] \
                    or cnt["plain"]:
                raise AssertionError(f"SPMD main path launches {cnt}: "
                                     f"expected {leaves} {B2_NAME} a step "
                                     "and nothing else")
            if not all(math.isfinite(x) for x in losses) or \
                    not losses[-1] < losses[0]:
                raise AssertionError(f"SPMD main path losses {losses}")
            if not all(isinstance(t, Z.DTensor) and t.device.type == "cuda"
                       for t in Z.tree_leaves(res.params)):
                raise AssertionError("SPMD params are not DTensors on the "
                                     "card")
            launches += cnt["b2"]
            main["profile"] = _spmd_profile(Z, cfg, mesh, res.params)
            pr = main["profile"]
            log(f"SPMD main path: {SPMD_ARCH} full width and depth (f32, "
                f"{leaves} leaves) on mesh (1, 1), {SPMD_STEPS} fused steps "
                f"in {wall:.2f} s: {main['ms_per_step']:.1f} ms/step, "
                f"{main['tokens_per_s']:.0f} tokens/s, peak "
                f"{peak / 2**30:.2f} GiB, {cnt['b2']} {B2_NAME} launches; "
                f"losses {losses}")
            log(f"  profiled step: {pr['step_ms']:.1f} ms, device busy "
                f"{pr['device_busy_ms']:.1f} ms (idle "
                f"{pr['device_idle_share']:.1%}), {pr['kernel_launches']} "
                f"kernels; B2 {pr['b2_ms']:.2f} ms ({pr['b2_share']:.1%}, "
                f"{pr['b2_launches']} launches)")
            for k in pr["top_kernels"]:
                log(f"    {k['ms']:8.3f} ms {k['share']:6.1%}  {k['name']}")
            out["main_path"] = main
            del res, params
            gc.collect()
            torch.cuda.empty_cache()

            # (b') the example's own form and (c) mesh against no mesh, at
            # full width and SPMD_CUT_LAYERS layers
            ccfg = replace_f32(Z.get_config(SPMD_ARCH),
                               n_layers=SPMD_CUT_LAYERS)
            out["mesh_vs_none"] = {}
            for form, steps in (("fused", SPMD_STEPS),
                                ("weighted", SPMD_WEIGHTED_STEPS)):
                legs = {}
                for leg in ("mesh", "none"):
                    log(f"  (c) {form}, {leg} (host {_host_gib():.1f} GiB)")
                    gen = torch.Generator(device="cuda").manual_seed(0)
                    p0 = Z.models.init_params(ccfg, gen, device="cuda")
                    if leg == "mesh":
                        p0 = Z.distribute_tree(p0, Z.param_specs(p0, mesh),
                                               mesh)
                    res, cnt, wall, peak = _spmd_run(
                        Z, ccfg, mesh if leg == "mesh" else None, p0,
                        form=form, steps=steps)
                    del p0
                    r = _run_record(Z, ccfg, res, cnt, wall, peak, steps)
                    want = leaves * steps if form == "fused" else 0
                    if cnt["b2"] != (want if leg == "mesh" else
                                     (steps if form == "fused" else 0)) or \
                            cnt["all"] != cnt["b2"] or cnt["plain"]:
                        raise AssertionError(f"{form} {leg} launches {cnt}")
                    if leg == "mesh":
                        launches += cnt["b2"]
                    r["params"] = _host_leaves(Z, res.params)
                    del res
                    gc.collect()
                    torch.cuda.empty_cache()
                    legs[leg] = r
                m, nm = legs["mesh"], legs["none"]
                same = all(torch.equal(a, b) for a, b in
                           zip(m.pop("params"), nm.pop("params")))
                rec_c = {"mesh": m, "none": nm, "params_bit_equal": same,
                         "losses_equal": m["losses"] == nm["losses"],
                         "mesh_cost": m["ms_per_step"] / nm["ms_per_step"]}
                out["mesh_vs_none"][form] = rec_c
                log(f"SPMD {form} ({SPMD_CUT_LAYERS} of 32 layers, {steps} "
                    f"steps): mesh {m['ms_per_step']:.1f} ms/step "
                    f"({m['tokens_per_s']:.0f} tokens/s, peak "
                    f"{m['peak_bytes'] / 2**30:.2f} GiB) vs no mesh "
                    f"{nm['ms_per_step']:.1f} ms/step ("
                    f"{nm['tokens_per_s']:.0f} tokens/s, peak "
                    f"{nm['peak_bytes'] / 2**30:.2f} GiB); params bit-equal: "
                    f"{same}; losses {m['losses']}")
                if not same:
                    raise AssertionError(f"SPMD {form}: the mesh run's "
                                         "params differ from the no-mesh "
                                         "run's")
                if not all(math.isfinite(x) for x in m["losses"]):
                    raise AssertionError(f"SPMD {form} losses {m['losses']}")

            # (d) the card's one-rank run against a 4-rank gloo CPU mesh
            log(f"  (d) card vs CPU mesh (host {_host_gib():.1f} GiB)")
            rcfg = Z.reduced(Z.get_config(SPMD_ARCH))
            p0 = Z.models.init_params(rcfg, torch.Generator().manual_seed(0),
                                      device="cpu")
            card, cnt, _, _ = _spmd_run(
                Z, rcfg, mesh, Z.tree_map(lambda t: t.cuda(), p0),
                form="fused", steps=SPMD_PARITY_STEPS)
            if cnt["b2"] != leaves * SPMD_PARITY_STEPS or \
                    cnt["all"] != cnt["b2"] or cnt["plain"]:
                raise AssertionError(f"SPMD parity card run launches {cnt}")
            launches += cnt["b2"]
            cpu = _cpu_mesh_runs(rcfg, p0)
            lc = [h["loss"] for h in card.history]
            pc = _host_leaves(Z, card.params)
            par = {}
            for fault, r in cpu.items():
                par["fault" if fault else "free"] = {
                    "loss_gap": max(abs(a - b) for a, b in
                                    zip(lc, r["losses"])),
                    "param_gap": max(float((a - b).abs().max())
                                     for a, b in zip(pc, r["params"]))}
            inside = {k: v["loss_gap"] <= TRAIN_PARITY_BAND["loss"] and
                      v["param_gap"] <= TRAIN_PARITY_BAND["params"]
                      for k, v in par.items()}
            out["parity"] = {**par, "inside": inside, "losses": lc}
            log(f"SPMD parity (reduced f32 {SPMD_ARCH}, {SPMD_PARITY_STEPS} "
                f"fused steps): card mesh (1, 1) vs CPU gloo mesh "
                f"{SPMD_CPU_MESH}: loss gap {par['free']['loss_gap']:.3g}, "
                f"param gap {par['free']['param_gap']:.3g}; planted per-rank "
                f"denominators: loss gap {par['fault']['loss_gap']:.3g}, "
                f"param gap {par['fault']['param_gap']:.3g} (bands "
                f"{TRAIN_PARITY_BAND['loss']:g} / "
                f"{TRAIN_PARITY_BAND['params']:g})")
            if not inside["free"]:
                raise AssertionError(f"card and CPU mesh disagree: {par}")
            if inside["fault"]:
                raise AssertionError(f"the planted fault lands inside the "
                                     f"band: {par}")
        finally:
            dist.destroy_process_group()
    rec["launches"] = launches
    return out, rec


# --------------------- phase 24: the encoder-decoder family -------------------
# seamless-m4t-large-v2 at full width and depth in bf16 (24 encoder and 24
# decoder layers, 16 / 16 heads of 64, d_ff 8192, vocab 256,206; weights
# from a seeded generator on the card, frames N(0, 1) from another): (a)
# the prefill on 2 x 4096 frames and 2 x 512 decoder tokens; (b) the
# serving example's static decode: 4 x 4096 frames encoded once into the
# cache, then one-token steps at a position on the card, a 32-token prompt
# stepped and 96 greedy tokens (max_seq 128, 127 steps); (c) 4 training
# steps (make_train_step, SGD momentum 0.9) on one batch of 2 x (4096
# frames, 256 tokens)
SEAMLESS_PREFILL_ROWS, SEAMLESS_PREFILL_TOKENS = 2, 512
SEAMLESS_DEC_ROWS, SEAMLESS_DEC_PROMPT, SEAMLESS_DEC_GEN = 4, 32, 96
SEAMLESS_TRAIN_ROWS, SEAMLESS_TRAIN_TOKENS, SEAMLESS_TRAIN_STEPS = 2, 256, 4
SEAMLESS_TRAIN_LR = 1e-3
# (d) card vs CPU on the reduced f32 model (2 + 2 layers, 4 / 4 heads of
# 64, encoder_seq 64) in the prefill, parity and training bands of phases
# 16, 21 and 19: 2 x 20 decoder tokens, the decode's 20-token prompt
# stepped and 8 greedy tokens, one train step at lr 0.05
SEAMLESS_PARITY_TOKENS, SEAMLESS_PARITY_GEN = 20, 8
SEAMLESS_PARITY_LR = 0.05


def _seamless_inputs(cfg, rows, s_dec, seed, device="cuda"):
    """Seeded N(0, 1) frames (rows, encoder_seq, D) in f32 and random
    decoder tokens (rows, s_dec) on ``device``."""
    import numpy as np
    gen = torch.Generator(device=device).manual_seed(seed)
    frames = torch.randn(rows, cfg.encoder_seq, cfg.d_model, generator=gen,
                         device=device)
    tok = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (rows, s_dec))).to(device)
    return frames, tok


def _encdec_generate(E, cfg, params, frames, prompts, gen):
    """The serving example's form: the frames encoded once into a fresh
    cache (``encdec.encode``), then ``make_decode_step`` one-token steps at
    an int32 position on the prompts' device advanced in place: the prompt
    stepped, then ``gen`` greedy tokens (max_seq = prompt + gen).  A CUDA
    event is recorded before and after each step on the card.  Returns
    (tokens (B, P + gen), the generated tokens' logits, the encode's
    launch counts, [(start, end) events], the cache, the step, pos)."""
    dev = prompts.device
    b, p = prompts.shape
    cache = E.models.init_cache(cfg, b, p + gen, device=dev)
    _reset_dec_counts(E)
    with torch.no_grad():
        cache["enc_out"] = E.encdec.encode(params, cfg, frames)
    enc_counts = _dec_counts(E)
    decode = E.make_decode_step(cfg)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    tok, out, seen, marks = prompts[:, :1], [prompts], [], []
    for t in range(p + gen - 1):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
        logits, cache = decode(params, cache, tok, pos)
        if dev.type == "cuda":
            z.record()
            marks.append((a, z))
        pos.add_(1)
        if t + 1 < p:
            tok = prompts[:, t + 1:t + 2]
        else:
            tok = logits.argmax(-1).to(prompts.dtype)[:, None]
            out.append(tok)
            seen.append(logits)
    return (torch.cat(out, dim=1), torch.stack(seen, dim=1), enc_counts,
            marks, cache, decode, pos)


def _encdec_step_profile(E, cfg, params, cache, decode, tok):
    """One one-token decode step (the last position of the cache, a 0-d
    int32 tensor on the card) under torch.profiler: device busy ms, idle
    share, the shares of B5 (self-attention) and B4 (cross-attention at
    one query), the copy kernels' time (the cross-attention's k / v in
    B4's layout among them) and the top kernels."""
    pos = torch.tensor(cache["k"].shape[2] - 1, dtype=torch.int32,
                       device="cuda")
    kern, count, wall = traced_kernels(
        lambda: decode(params, cache, tok, pos),
        ("decode_kernel", "attention_wgmma_kernel"), 2 * cfg.n_layers)
    busy = sum(kern.values())
    part = lambda key: sum(us for n, us in kern.items() if key in n)
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (wall * 1e6),
            "kernel_launches": sum(count.values()),
            "b5_ms": part("decode_kernel") / 1e3,
            "b5_share": part("decode_kernel") / busy,
            "b4_ms": part("attention_wgmma_kernel") / 1e3,
            "b4_share": part("attention_wgmma_kernel") / busy,
            "copy_launches": sum(c for n, c in count.items() if "copy" in n),
            "copy_ms": part("copy") / 1e3, "copy_share": part("copy") / busy,
            "top_kernels": [{"name": n[:90], "ms": us / 1e3,
                             "share": us / busy} for n, us in top]}


def _no_kernel(counts):
    return {k: 0 for k in counts}


def encdec_prefill(E, cfg, params):
    """Phase 24 (a): ``make_prefill_step(cfg)(params, tokens, frames)``:
    exactly 72 B4 launches (24 encoder, 24 causal decoder, 24 cross) and
    nothing else, finite (rows, vocab) logits; ms a prefill (median of
    PREFILL_TIMED), frame + token throughput, a profile and peak memory."""
    rows, s_dec = SEAMLESS_PREFILL_ROWS, SEAMLESS_PREFILL_TOKENS
    frames, tokens = _seamless_inputs(cfg, rows, s_dec, 21)
    prefill = E.make_prefill_step(cfg)
    prefill(params, tokens, frames)                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_dec_counts(E)
    logits = prefill(params, tokens, frames)
    torch.cuda.synchronize()
    got = _dec_counts(E)
    peak = torch.cuda.max_memory_allocated()
    want = dict(_no_kernel(got), flash_attention=cfg.encoder_layers
                + 2 * cfg.n_layers)
    if got != want:
        raise AssertionError(f"{SEAMLESS} prefill: launches {got}, expected "
                             f"{want}")
    if tuple(logits.shape) != (rows, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{SEAMLESS} prefill: logits "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    times = []
    for _ in range(PREFILL_TIMED):
        t0 = time.perf_counter()
        prefill(params, tokens, frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * statistics.median(times)
    prof = _prefill_profile(lambda p, t: prefill(p, t, frames), params,
                            tokens, {"flash_attention": want[
                                "flash_attention"]})
    n_in = rows * (cfg.encoder_seq + s_dec)
    rec = {"rows": rows, "frames": cfg.encoder_seq, "tokens": s_dec,
           "ms_per_prefill": ms,
           "ms_per_prefill_runs": [1e3 * t for t in times],
           "inputs_per_s": n_in / (ms / 1e3), "launches": got,
           "peak_bytes": peak, "profile": prof}
    log(f"encoder-decoder prefill: {SEAMLESS} full width, {rows} x "
        f"({cfg.encoder_seq} frames + {s_dec} tokens): {ms:.1f} ms a "
        f"prefill (runs {[round(1e3 * t, 1) for t in times]}), "
        f"{rec['inputs_per_s']:.0f} frames + tokens/s; launches {got}; peak "
        f"{peak / 2**30:.2f} GiB")
    log(f"  profiled prefill: {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['device_busy_ms']:.1f} ms (idle "
        f"{prof['device_idle_share']:.1%}); B4 {prof['b4_share']:.1%} of "
        f"device time; copy kernels {prof['copy_launches']} launches, "
        f"{prof['copy_ms']:.2f} ms ({prof['copy_share']:.1%})")
    for k in prof["top_kernels"]:
        log(f"    {k['ms']:8.3f} ms {k['share']:6.1%}  {k['name']}")
    if not prof["b4_share"] > 0:
        raise AssertionError("the profiled prefill finds no time under B4's "
                             "names")
    return rec, got


def encdec_decode(E, cfg, params):
    """Phase 24 (b): the serving example's static decode at full width:
    the encode (exactly 24 B4), then 127 one-token steps (24 B5 and 24 B4
    each, nothing else), tokens in the vocabulary, finite logits; ms a
    step (CUDA events around each call), tokens/s, peak memory and one
    profiled step."""
    rows, plen, gen = SEAMLESS_DEC_ROWS, SEAMLESS_DEC_PROMPT, SEAMLESS_DEC_GEN
    frames, prompts = _seamless_inputs(cfg, rows, plen, 23)
    _encdec_generate(E, cfg, params, frames, prompts[:, :2], 2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks, logits, enc, marks, cache, decode, _ = _encdec_generate(
        E, cfg, params, frames, prompts, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _dec_counts(E)
    peak = torch.cuda.max_memory_allocated()
    n_steps = plen + gen - 1
    want_enc = dict(_no_kernel(enc), flash_attention=cfg.encoder_layers)
    want = dict(_no_kernel(got),
                flash_attention=cfg.encoder_layers + cfg.n_layers * n_steps,
                flash_decode=cfg.n_layers * n_steps)
    if enc != want_enc or got != want or len(marks) != n_steps:
        raise AssertionError(f"{SEAMLESS} static decode: encode launches "
                             f"{enc}, in all {got} over {len(marks)} steps; "
                             f"expected {want_enc} and {want}")
    _check_tokens(SEAMLESS, toks, logits, cfg, rows, plen + gen)
    if not torch.equal(toks[:, :plen], prompts):
        raise AssertionError(f"{SEAMLESS}: the decode changed the prompts")
    steps = [a.elapsed_time(marks[i + 1][0] if i + 1 < len(marks) else z)
             for i, (a, z) in enumerate(marks)]
    greedy = steps[plen:]
    med = statistics.median(greedy)
    prof = _encdec_step_profile(E, cfg, params, cache, decode,
                                toks[:, -1:])
    rec = {"rows": rows, "frames": cfg.encoder_seq, "prompt": plen,
           "generated": gen, "max_seq": plen + gen, "steps": n_steps,
           "wall_s": wall, "tokens_per_s": rows * gen / wall,
           "ms_per_step": med, "ms_per_step_min": min(greedy),
           "ms_per_step_max": max(greedy),
           "stepped_prompt_ms": sum(steps[:plen]),
           "decode_tokens_per_s": rows / (med / 1e3),
           "launches": got, "encode_launches": enc, "peak_bytes": peak,
           "profile": prof}
    log(f"encoder-decoder static decode: {SEAMLESS} full width, {rows} x "
        f"{cfg.encoder_seq} frames encoded, {plen} prompt tokens stepped + "
        f"{gen} generated: {wall:.2f} s, {rec['tokens_per_s']:.1f} generated "
        f"tokens/s; {med:.2f} ms a decode step (min {min(greedy):.2f}, max "
        f"{max(greedy):.2f}; {rec['decode_tokens_per_s']:.0f} tokens/s at "
        f"batch {rows}); launches {got} ({n_steps} steps); peak "
        f"{peak / 2**30:.2f} GiB")
    log(f"  profiled decode step: {prof['wall_ms']:.2f} ms, device busy "
        f"{prof['device_busy_ms']:.2f} ms (idle "
        f"{prof['device_idle_share']:.1%}), {prof['kernel_launches']} "
        f"kernels; B5 {prof['b5_ms']:.3f} ms ({prof['b5_share']:.1%}), B4 "
        f"(cross, one query) {prof['b4_ms']:.3f} ms ({prof['b4_share']:.1%}),"
        f" copy kernels {prof['copy_launches']} launches, "
        f"{prof['copy_ms']:.3f} ms ({prof['copy_share']:.1%})")
    for k in prof["top_kernels"]:
        log(f"    {k['ms']:8.3f} ms {k['share']:6.1%}  {k['name']}")
    if not (prof["b5_share"] > 0 and prof["b4_share"] > 0):
        raise AssertionError("the profiled decode step finds no time under "
                             "B4's or B5's name")
    return rec, got


def _train_batch(cfg, rows, s_dec, seed, device):
    frames, tok = _seamless_inputs(cfg, rows, s_dec + 1, seed, device)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:], "frames": frames}


def encdec_train(E, cfg, params):
    """Phase 24 (c): ``make_train_step(cfg, sgd_momentum(0.9))`` on one
    batch, SEAMLESS_TRAIN_STEPS steps: no B4 / B5 launch and no plain
    attention (the training forward runs the scans), finite losses, the
    params changed; ms a step and peak memory."""
    rows, s_dec = SEAMLESS_TRAIN_ROWS, SEAMLESS_TRAIN_TOKENS
    batch = _train_batch(cfg, rows, s_dec, 25, "cuda")
    opt = E.sgd_momentum(0.9)
    step = E.make_train_step(cfg, opt)
    state, p = opt.init(params), params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_dec_counts(E)
    times, losses = [], []
    for _ in range(SEAMLESS_TRAIN_STEPS):
        t0 = time.perf_counter()
        p, state, loss = step(p, state, batch, SEAMLESS_TRAIN_LR)
        losses.append(float(loss))                        # syncs
        times.append(time.perf_counter() - t0)
    got = _dec_counts(E)
    peak = torch.cuda.max_memory_allocated()
    moved = max(float((a.float() - b.float()).abs().max()) for a, b in
                zip(E.tree_leaves(p), E.tree_leaves(params)))
    if got != _no_kernel(got) or not all(map(math.isfinite, losses)) or \
            not moved > 0:
        raise AssertionError(f"{SEAMLESS} training: launches {got}, losses "
                             f"{losses}, largest param move {moved}")
    ms = 1e3 * statistics.median(times[1:])
    rec = {"rows": rows, "frames": cfg.encoder_seq, "tokens": s_dec,
           "steps": SEAMLESS_TRAIN_STEPS, "lr": SEAMLESS_TRAIN_LR,
           "ms_per_step": ms, "step_ms": [1e3 * t for t in times],
           "losses": losses, "param_move": moved, "peak_bytes": peak,
           "launches": got}
    log(f"encoder-decoder training: {SEAMLESS} full width (block remat), "
        f"{rows} x ({cfg.encoder_seq} frames + {s_dec} tokens), "
        f"{SEAMLESS_TRAIN_STEPS} SGD-momentum steps: {ms:.0f} ms a step "
        f"after the first (steps {[round(1e3 * t) for t in times]} ms), "
        f"losses {[round(x, 4) for x in losses]}; no B4 / B5 launch; peak "
        f"{peak / 2**30:.2f} GiB")
    del p, state
    return rec


def encdec_parity(E):
    """Phase 24 (d): reduced f32 seamless on the card against the CPU port
    on the same params and inputs: prefill logits within
    PREFILL_PARITY_BAND (and the planted causal encoder outside it), the
    example's encode + stepped decode with identical greedy tokens and
    logits within DECODE_PARITY_BAND, one train step within
    TRAIN_PARITY_BAND."""
    cfg = E.reduced(E.get_config(SEAMLESS))
    p_cpu = E.models.init_params(cfg, torch.Generator().manual_seed(3),
                                 device="cpu")
    p_card = E.tree_map(lambda t: t.cuda(), p_cpu)
    frames, tok = _seamless_inputs(cfg, 2, SEAMLESS_PARITY_TOKENS, 5, "cpu")
    on_card = lambda t: t.cuda()
    threads = torch.get_num_threads()

    def cpu(fn):
        torch.set_num_threads(1)
        try:
            return fn()
        finally:
            torch.set_num_threads(threads)
    prefill = E.make_prefill_step(cfg)
    torch.backends.cuda.matmul.allow_tf32 = True       # the step turns it
    _reset_dec_counts(E)                               # off itself
    card = prefill(p_card, on_card(tok), on_card(frames)).cpu()
    got = _dec_counts(E)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the prefill step left TF32 on")
    want = cpu(lambda: prefill(p_cpu, tok, frames))
    real = E.encdec.chunked_attention
    E.encdec.chunked_attention = lambda q, k, v, **kw: real(
        q, k, v, **{**kw, "causal": True})
    try:
        fault = prefill(p_card, on_card(tok), on_card(frames)).cpu()
    finally:
        E.encdec.chunked_attention = real
    out = {"prefill": {"logit_gap": float((card - want).abs().max()),
                       "fault_gap": float((fault - want).abs().max()),
                       "logit_max": float(want.abs().max()),
                       "launches": got}}
    r = out["prefill"]
    log(f"encoder-decoder parity, {SEAMLESS} reduced (f32, 2 + 2 layers, "
        f"{cfg.encoder_seq} frames, {SEAMLESS_PARITY_TOKENS} tokens), card "
        f"vs CPU: prefill logit gap {r['logit_gap']:.3g} (band "
        f"{PREFILL_PARITY_BAND:g}, logits up to {r['logit_max']:.2f}); the "
        f"planted causal encoder {r['fault_gap']:.3g}; launches {got}")
    if not r["logit_gap"] <= PREFILL_PARITY_BAND or \
            r["fault_gap"] <= PREFILL_PARITY_BAND or got["plain_attention"] \
            or got["flash_attention"] != cfg.encoder_layers + 2 * cfg.n_layers:
        raise AssertionError(f"{SEAMLESS} reduced prefill, card vs CPU: {r}")

    gen = SEAMLESS_PARITY_GEN
    c_t, c_l, _, _, _, _, _ = _encdec_generate(
        E, cfg, p_card, on_card(frames), on_card(tok), gen)
    got = _dec_counts(E)
    x_t, x_l, _, _, _, _, _ = cpu(lambda: _encdec_generate(
        E, cfg, p_cpu, frames, tok, gen))
    n_steps = SEAMLESS_PARITY_TOKENS + gen - 1
    r = out["decode"] = {"logit_gap": float((c_l.cpu() - x_l).abs().max()),
                         "tokens_equal": bool(torch.equal(c_t.cpu(), x_t)),
                         "launches": got}
    log(f"  encode + stepped decode ({SEAMLESS_PARITY_TOKENS} + {gen}): "
        f"tokens equal {r['tokens_equal']}, logit gap {r['logit_gap']:.3g} "
        f"(band {DECODE_PARITY_BAND:g}); launches {got}")
    if not r["tokens_equal"] or not r["logit_gap"] <= DECODE_PARITY_BAND \
            or got["plain_attention"] or \
            got["flash_decode"] != cfg.n_layers * n_steps:
        raise AssertionError(f"{SEAMLESS} reduced decode, card vs CPU: {r}")

    opt = E.sgd_momentum(0.9)
    step = E.make_train_step(cfg, opt)
    batch = _train_batch(cfg, 2, SEAMLESS_PARITY_TOKENS, 7, "cpu")
    _reset_dec_counts(E)
    cp, _, closs = step(p_card, opt.init(p_card),
                        {k: on_card(v) for k, v in batch.items()},
                        SEAMLESS_PARITY_LR)
    got = _dec_counts(E)
    xp, _, xloss = cpu(lambda: step(p_cpu, opt.init(p_cpu), batch,
                                    SEAMLESS_PARITY_LR))
    r = out["train"] = {
        "loss_gap": abs(float(closs) - float(xloss)),
        "param_gap": _leaf_gaps(E.tree_leaves(cp), E.tree_leaves(xp)),
        "loss": float(xloss), "launches": got}
    log(f"  one train step (SGD momentum 0.9, lr {SEAMLESS_PARITY_LR:g}): "
        f"loss gap {r['loss_gap']:.3g}, param gap {r['param_gap']:.3g} "
        f"(bands {TRAIN_PARITY_BAND['loss']:g} / "
        f"{TRAIN_PARITY_BAND['params']:g}); launches {got}")
    if not r["loss_gap"] <= TRAIN_PARITY_BAND["loss"] or \
            not r["param_gap"] <= TRAIN_PARITY_BAND["params"] or \
            got != _no_kernel(got):
        raise AssertionError(f"{SEAMLESS} reduced train step, card vs CPU: "
                             f"{r}")
    return out


def encdec_phase(E):
    """Phase 24: seamless-m4t-large-v2 at full width and depth in bf16 on
    the prefill (a), the static decode (b) and training (c) paths (its
    kernel geometries ran in phases 14 and 21), then the reduced model
    card vs CPU (d).  Returns (records, B4 and B5 launches of (a) and
    (b))."""
    cfg = E.get_config(SEAMLESS)
    t0 = time.perf_counter()
    params = E.models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "params": sum(t.numel() for t in E.tree_leaves(params)),
           "weight_bytes": sum(t.numel() * t.element_size()
                               for t in E.tree_leaves(params))}
    log(f"encoder-decoder: {SEAMLESS} {out['params'] / 1e9:.3f} B params "
        f"({out['weight_bytes'] / 1e9:.2f} GB bf16), drawn in "
        f"{out['init_s']:.2f} s")
    out["prefill"], pf = encdec_prefill(E, cfg, params)
    out["decode"], dl = encdec_decode(E, cfg, params)
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = encdec_train(E, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["parity"] = encdec_parity(E)
    launches = {k: pf[k] + dl[k] for k in ("flash_attention",
                                           "flash_decode")}
    return out, launches


# ------------------- phase 25: the remaining configs and shapes ---------------
# llama3-405b (128 / 8 heads of 128, n_rep 16), deepseek-67b and
# chameleon-34b (64 / 8, n_rep 8) and arctic-480b (56 / 8, n_rep 7; 128
# experts, top-2, dense residual) at full width in bf16 on seeded random
# weights drawn on the card, the depth cut so that the params and
# decode_32k's cache fit one 80 GB card, run through the reference's input
# shapes (configs/shapes.py) with prefill_32k's batch cut from 32 to 1
BIG_LAYERS = {"llama3-405b": 2, "deepseek-67b": 2, "arctic-480b": 1,
              "chameleon-34b": 2}
BIG_PREFILL_BATCH = 1
BIG_STEPS = 8            # one-token steps at decode_32k and at long_500k
# the B4 and B5 rows at the paths' geometries: one a distinct (n_rep, hd)
# (the chameleon cut shares deepseek's); B4's plain version at 32,768
# tokens runs BIG_B4_BLOCK queries of one KV head's query heads a call
BIG_ROWS = ("llama3-405b", "deepseek-67b", "arctic-480b")
BIG_B4_BLOCK = 1024
# card vs CPU: reduced f32 models that keep each n_rep at hd 128 (reduced()
# alone gives 4 / 1 heads), 2 layers, arctic 4 experts, top-2, the dense
# residual; then a long_500k-named shape of 64 positions at window 16
BIG_REDUCED = {"llama3-405b": dict(n_heads=16, d_model=2048),
               "deepseek-67b": dict(n_heads=8, d_model=1024),
               "arctic-480b": dict(n_heads=7, d_model=896),
               "chameleon-34b": dict(n_heads=8, d_model=1024)}
BIG_LONG = dict(name="long_500k", seq_len=64, global_batch=2, kind="decode")
BIG_LONG_WINDOW, BIG_LONG_PROMPT = 16, 40
# (f) the paged serving engine on the BIG_ROWS configs at full width and
# BIG_LAYERS depth, on the params (b)-(d) ran: phase 12's requests, pages
# and chunk with bf16 pages (the cache dtype a deployment of these sizes
# keeps), greedy and sampled; B6 runs its kRep-8 form in every layer of
# every one-token tick (n_rep 16: two groups a KV head, the pages read
# twice; 8: one group; 7: one of 7 in 8).  Chameleon-34b shares
# deepseek's n_rep and hd, so it would run the same form: it is left out.
BIG_SERVE_LEGS = ("paged_recorded", "paged", "paged_sampled")


def _fill_kv(cache, gen):
    """Every attention K / V leaf of a decode cache filled in place with
    N(0, 1) values drawn on the card (in its bf16)."""
    for c in cache:
        for key in ("k", "v"):
            if key in c:
                c[key].normal_(generator=gen)


def big_abstract(G):
    """Phase 25 (a): ``launch.specs.abstract_params`` of the ten LM
    configs at full depth and ``input_specs`` of every (config, shape)
    pair: meta trees only, the card's allocated bytes unchanged."""
    before = torch.cuda.memory_allocated()
    out = {}
    for arch in G.ARCH_IDS:
        cfg = G.get_config(arch)
        tree = G.specs.abstract_params(cfg)
        leaves = G.tree_leaves(tree)
        n = sum(t.numel() for t in leaves)
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        spec_bytes = {}
        for name, shape in G.SHAPES.items():
            spec = G.specs.input_specs(cfg, shape)
            ls = G.tree_leaves(spec)
            if not all(t.is_meta for t in ls):
                raise AssertionError(f"{arch} {name}: input_specs holds a "
                                     "tensor that is not on the meta device")
            spec_bytes[name] = sum(t.numel() * t.element_size() for t in ls)
        if not all(t.is_meta for t in leaves):
            raise AssertionError(f"{arch}: abstract_params holds a tensor "
                                 "that is not on the meta device")
        out[arch] = {"params": n, "analytic_params": cfg.param_count(),
                     "bytes": nbytes,
                     "window_long_500k": G.specs.effective_window(
                         cfg, G.SHAPES["long_500k"]),
                     "input_bytes": spec_bytes}
        log(f"  {arch}: abstract_params {n:,} params, {nbytes / 1e9:.1f} "
            f"GB in its dtypes; decode_32k inputs "
            f"{spec_bytes['decode_32k'] / 1e9:.1f} GB, long_500k "
            f"{spec_bytes['long_500k'] / 1e9:.1f} GB (window "
            f"{out[arch]['window_long_500k']})")
    after = torch.cuda.memory_allocated()
    if after != before:
        raise AssertionError(f"the abstract trees allocated {after - before} "
                             "bytes on the card")
    return out


def _big_want(b4=0, b5=0, b6=0):
    """The counts (``_dec_counts``) a phase-25 run must read: ``b4`` B4,
    ``b5`` B5 and ``b6`` B6 launches and nothing else."""
    return {"flash_decode": b5, "flash_decode_paged": b6,
            "flash_attention": b4, "mamba_ssd_scan": 0, "wkv6_chunked": 0,
            "plain_attention": 0}


def big_prefill(G, arch, cfg, params):
    """Phase 25 (b): ``make_prefill_step(cfg)`` at prefill_32k's sequence
    (batch cut to 1, tokens of its input spec's shape and dtype drawn on
    the card): one B4 launch a layer and nothing else, finite (1, vocab)
    logits; ms a prefill (median of 3), tokens/s, peak memory, a profile
    (arctic: the MoE layer's split)."""
    shape = G.replace(G.SHAPES["prefill_32k"],
                      global_batch=BIG_PREFILL_BATCH)
    spec = G.specs.input_specs(cfg, shape)["tokens"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, tuple(spec.shape),
                           dtype=spec.dtype, device="cuda", generator=gen)
    prefill = G.make_prefill_step(cfg)
    prefill(params, tokens)                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_dec_counts(G)
    logits = prefill(params, tokens)
    torch.cuda.synchronize()
    got = _dec_counts(G)
    peak = torch.cuda.max_memory_allocated()
    want = _big_want(b4=cfg.n_layers)
    if got != want:
        raise AssertionError(f"{arch} prefill: launches {got}, expected "
                             f"{want}")
    if tuple(logits.shape) != (BIG_PREFILL_BATCH, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} prefill: logits {tuple(logits.shape)}"
                             f", finite {bool(torch.isfinite(logits).all())}")
    times = []
    for _ in range(PREFILL_TIMED):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        prefill(params, tokens)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    ms = statistics.median(times)
    n_tok = tokens.numel()
    prof = _prefill_profile(prefill, params, tokens,
                            {"flash_attention": cfg.n_layers})
    rec = {"tokens": n_tok, "ms_per_prefill": ms, "ms_runs": times,
           "tokens_per_s": n_tok / (ms / 1e3), "peak_bytes": peak,
           "launches": got, "profile": {k: prof[k] for k in (
               "wall_ms", "device_busy_ms", "device_idle_share", "b4_share",
               "copy_ms", "copy_share", "top_kernels")}}
    log(f"  prefill ({BIG_PREFILL_BATCH} x {spec.shape[1]} tokens): "
        f"{ms:.1f} ms (runs {[round(t, 1) for t in times]}), "
        f"{rec['tokens_per_s']:.0f} tokens/s, peak {peak / 2**30:.2f} GiB; "
        f"{got['flash_attention']} B4 launches; profiled: device busy "
        f"{prof['device_busy_ms']:.1f} ms of {prof['wall_ms']:.1f} (idle "
        f"{prof['device_idle_share']:.1%}), B4 {prof['b4_share']:.1%}, "
        f"copies {prof['copy_share']:.1%}")
    for k in prof["top_kernels"][:6]:
        log(f"    {k['ms']:8.3f} ms {k['share']:6.1%}  {k['name']}")
    if not prof["b4_share"] > 0:
        raise AssertionError(f"{arch} prefill launched B4 but the profile "
                             "finds no time under its names")
    if cfg.moe:
        rec["moe_split"] = _moe_split(G, prefill, params, tokens)
    return rec, got


def _b4_big_row(G, arch, cfg, s, rate):
    """B4 at a prefill's geometry (causal, 1 x ``s`` tokens, the config's
    heads) on seeded N(0, 1) bf16 q, k, v: against its plain version
    (PF_F32_TOL plus one bf16 ulp) run one KV head's n_rep query heads and
    BIG_B4_BLOCK queries at a time over the keys they see (the last block
    all ``s``), where the whole would need the full score matrix; timed
    (events) beside the bound, the plain version's loop and one SDPA call
    (causal, ``enable_gqa``, fused backends only)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: B4's plain version would not be "
                             "the f32 oracle")
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_rep = h // kvh
    gen = torch.Generator(device="cuda").manual_seed(27)
    mk = lambda *sh: torch.randn(*sh, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = mk(1, h, s, hd), mk(1, kvh, s, hd), mk(1, kvh, s, hd)
    kern = lambda: G.FA.flash_attention(q, k, v, causal=True)
    got = kern()

    def plain(check):
        err = ratio = 0.0
        for g in range(kvh):
            hs = slice(g * n_rep, (g + 1) * n_rep)
            for i0 in range(0, s, BIG_B4_BLOCK):
                i1 = min(s, i0 + BIG_B4_BLOCK)
                want = G.FA.flash_attention_plain(
                    q[:, hs, i0:i1], k[:, g:g + 1, :i1], v[:, g:g + 1, :i1],
                    causal=True, q_offset=i0)
                if check:
                    e, r = _pf_err("flash_attention", got[:, hs, i0:i1],
                                   want)
                    err, ratio = max(err, e), max(ratio, r)
        return err, ratio
    err, ratio = plain(check=True)
    torch.cuda.synchronize()
    if not ratio <= 1.0 or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash_attention {arch} 1 x {s}: kernel differs "
                             f"from its plain version by {err} ({ratio:.3g} "
                             "x the tolerance)")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    plain(check=False)
    b.record()
    b.synchronize()
    bound_ms, by, flops, nbytes, _ = _pf_bound("flash_attention", (q, k, v),
                                               rate)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), per_group=2, groups=3,
            warmup=1)
    rec = {"shape": f"{arch} prefill_32k", "dtype": "bfloat16",
           "heads": (h, kvh), "hd": hd, "tokens": s, "max_abs_err": err,
           "err_over_tol": ratio,
           "ms": cuda_ms(kern, per_group=2, groups=3, warmup=1),
           "plain_ms": a.elapsed_time(b),
           "plain_form": f"{n_rep} heads x {BIG_B4_BLOCK} queries at a time",
           "bound_ms": bound_ms, "bound_by": by, "flops": flops,
           "bytes": nbytes, "library_ms": lib_ms}
    log(f"    B4 {arch} (1 x {s} causal, {h} / {kvh} heads of {hd}, bf16): "
        f"{rec['ms']:.2f} ms, bound {bound_ms:.2f} ms by {by} "
        f"({bound_ms / rec['ms']:.0%}), plain {rec['plain_ms']:.0f} ms "
        f"({rec['plain_form']}), SDPA {lib_ms:.2f} ms, err {err:.3g} "
        f"({ratio:.3g} x the tolerance)")
    return rec


def _b5_big_row(G, label, q, kt, vt, pos, w, rate):
    """B5 at a path's geometry on a layer cache as the path lays it out
    (the ``transpose(1, 2)`` view of ``(B, S, KV, hd)``), bf16: against its
    plain version (FD_F32_TOL plus one bf16 ulp) run on the live keys alone
    (the keys ``pos - w + 1 .. pos``; those outside are masked anyway) a
    row at a time, where the whole would not fit the card; timed (events,
    device time) beside the bytes bound, the plain version's loop and one
    SDPA call on the live keys: each KV head's n_rep query heads as n_rep
    queries of one head (a view of q), so that no mask and no GQA
    expansion is asked of it."""
    rows, h = q.shape[:2]
    kvh, s, hd = kt.shape[1], kt.shape[2], kt.shape[3]
    lo = max(0, pos - w + 1) if w > 0 else 0
    kl, vl = kt[:, :, lo:pos + 1], vt[:, :, lo:pos + 1]
    qg = q.view(rows, kvh, h // kvh, hd)
    kern = lambda: G.FD.flash_decode(q, kt, vt, pos, window=w)
    got = kern()

    def plain():
        return torch.cat([G.FD._xla_decode(q[r:r + 1], kl[r:r + 1],
                                           vl[r:r + 1], pos - lo)
                          for r in range(rows)])
    want = plain()
    torch.cuda.synchronize()
    err, ok, worst = _fd_err(got, want)
    if not ok:
        raise AssertionError(f"flash_decode {label} pos {pos} window {w}: "
                             f"kernel differs from its plain version by "
                             f"{err}; worst {worst}")
    dev_pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    if not torch.equal(G.FD.flash_decode(q, kt, vt, dev_pos, window=w), got):
        raise AssertionError(f"flash_decode {label}: the device pos gives "
                             "other bits than the host int")
    bound_ms, by, nbytes = _b5_bound(q, kt, pos, w, rate)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    plain()
    b.record()
    b.synchronize()
    rec = {"shape": label, "q": "bfloat16", "cache": "bfloat16",
           "layout": "(B, S, KV, hd)", "rows": rows, "heads": (h, kvh),
           "hd": hd, "keys": s, "pos": pos, "window": w, "max_abs_err": err,
           "split": G.FD.decode_cluster_size(
               rows, h, kvh, s,
               torch.cuda.get_device_properties(0).multi_processor_count,
               hd, kt.element_size(), w),
           "ms": cuda_ms(kern, groups=5), "device_ms": device_ms(kern),
           "device_ms_pos_on_card": device_ms(
               lambda: G.FD.flash_decode(q, kt, vt, dev_pos, window=w)),
           "plain_ms": a.elapsed_time(b), "plain_form": "a row at a time",
           "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes,
           "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
               qg, kl, vl).view(rows, h, 1, hd), groups=5)}
    log(f"    B5 {label} ({rows} x {h} / {kvh} heads of {hd}, {s} keys, pos "
        f"{pos}, window {w}; cluster {rec['split']}): "
        f"{rec['ms'] * 1e3:.1f} us, device {rec['device_ms'] * 1e3:.1f} us "
        f"(pos on the card {rec['device_ms_pos_on_card'] * 1e3:.1f}), bound "
        f"{bound_ms * 1e3:.1f} us by {by} ({nbytes / 1e6:.1f} MB; "
        f"{bound_ms / rec['device_ms']:.0%} of device time), plain "
        f"{rec['plain_ms']:.1f} ms (a row at a time), SDPA "
        f"{rec['library_ms'] * 1e3:.1f} us, err {err:.3g}")
    return rec


def _big_steps(G, step, params, cache, tok, pos0, n):
    """``n`` one-token steps of ``step`` from a device ``pos`` of ``pos0``
    advanced in place, the greedy token fed back: (last logits, CUDA-event
    ms of each step)."""
    pos = torch.tensor(pos0, dtype=torch.int32, device="cuda")
    marks = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        logits, cache = step(params, cache, tok, pos)
        b.record()
        marks.append((a, b))
        tok = logits.argmax(-1)[:, None]
        pos.add_(1)
    torch.cuda.synchronize()
    return logits, [a.elapsed_time(b) for a, b in marks]


def big_decode(G, arch, cfg, params, shape_name, rate):
    """Phase 25 (c) / (d): ``make_decode_step(cfg, SHAPES[shape_name])``
    on ``init_cache(cfg, B, S)`` of that shape, K / V filled with N(0, 1)
    bf16 draws on the card: BIG_STEPS one-token steps from a device pos of
    S - BIG_STEPS - 1, exactly one B5 launch a layer a step and nothing
    else, finite logits; ms a step; B5's row at this geometry (on layer
    0's cache at pos S - 1).  At long_500k (the window override) also the
    planted check: every key and value before the window rewritten, the
    same step gives bit-equal logits; the step without the shape differs."""
    shape = G.SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    w = G.specs.effective_window(cfg, shape)
    gen = torch.Generator(device="cuda").manual_seed(21)
    torch.cuda.reset_peak_memory_stats()
    cache = G.models.init_cache(cfg, b, s, device="cuda")
    _fill_kv(cache, gen)
    step = G.make_decode_step(cfg, shape)
    tok = torch.randint(0, cfg.vocab_size, (b, 1), device="cuda",
                        generator=gen)
    pos0 = s - BIG_STEPS - 1
    _big_steps(G, step, params, cache, tok, pos0, 1)          # warm-up
    _reset_dec_counts(G)
    logits, ms = _big_steps(G, step, params, cache, tok, pos0, BIG_STEPS)
    got = _dec_counts(G)
    peak = torch.cuda.max_memory_allocated()
    want = _big_want(b5=BIG_STEPS * cfg.n_layers)
    if got != want:
        raise AssertionError(f"{arch} {shape_name}: launches {got}, "
                             f"expected {want}")
    if tuple(logits.shape) != (b, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} {shape_name}: logits "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    rec = {"rows": b, "keys": s, "window": w, "pos": [pos0, pos0 + BIG_STEPS
                                                      - 1],
           "ms_per_step": statistics.median(ms), "ms_steps": ms,
           "tokens_per_s": b / (statistics.median(ms) / 1e3),
           "peak_bytes": peak, "launches": got,
           "cache_bytes": sum(t.numel() * t.element_size()
                              for t in G.tree_leaves(cache))}
    log(f"  {shape_name} ({b} rows, cache {s}, window {w or 'none'}; "
        f"{rec['cache_bytes'] / 1e9:.1f} GB of K / V): "
        f"{rec['ms_per_step']:.2f} ms a step (steps "
        f"{[round(t, 2) for t in ms]}), {rec['tokens_per_s']:.0f} tokens/s, "
        f"peak {peak / 2**30:.2f} GiB; launches {got}")
    if shape_name == "long_500k":
        if not w:
            raise AssertionError(f"{arch}: long_500k runs no window")
        last = s - 1
        gen2 = torch.Generator(device="cuda").manual_seed(23)
        tok = torch.randint(0, cfg.vocab_size, (b, 1), device="cuda",
                            generator=gen2)
        first, _ = step(params, cache, tok, last)
        lo = last - w + 1
        for c in cache:
            for key in ("k", "v"):
                c[key][:, :, :lo].normal_(generator=gen2)
        again, _ = step(params, cache, tok, last)
        free, _ = G.make_decode_step(cfg)(params, cache, tok, last)
        torch.cuda.synchronize()
        rec["planted"] = {
            "outside_rewritten_bit_equal": bool(torch.equal(first, again)),
            "without_override_gap": float((free.float()
                                           - first.float()).abs().max())}
        log(f"    planted: keys and values before {lo} rewritten, the "
            f"windowed step's logits bit-equal "
            f"{rec['planted']['outside_rewritten_bit_equal']}; the step "
            f"without the shape (every key) "
            f"{rec['planted']['without_override_gap']:.3g} away")
        if not rec["planted"]["outside_rewritten_bit_equal"] or \
                not rec["planted"]["without_override_gap"] > 0:
            raise AssertionError(f"{arch} long_500k: the window override "
                                 f"does not hold: {rec['planted']}")
    if arch in BIG_ROWS:
        gq = torch.Generator(device="cuda").manual_seed(25)
        q = torch.randn(b, cfg.n_heads, 1, cfg.head_dim, generator=gq,
                        device="cuda").to(torch.bfloat16)
        kt = cache[0]["k"][0].transpose(1, 2)
        vt = cache[0]["v"][0].transpose(1, 2)
        rec["b5"] = _b5_big_row(G, f"{arch} {shape_name}", q, kt, vt, s - 1,
                                w, rate)
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    return rec, got


class _TickHooks(_StubHooks):
    """Stub hooks that mirror the paged engine's page table and lengths
    and keep those of the first decode tick with every slot busy: B6's
    table rows and lengths at that tick, in the tick's row order."""

    def __init__(self, spec):
        import numpy as np
        self.sentinel, self.n_slots = spec.n_pages, spec.n_slots
        self.table = np.full((spec.n_slots, spec.pages_per_slot),
                             spec.n_pages, np.int32)
        self.lengths = np.zeros((spec.n_slots,), np.int32)
        self.full = None

    def admit(self, slot, req, pages, *, start=0, **kw):
        self.table[slot] = self.sentinel
        self.table[slot, :len(pages)] = pages
        self.lengths[slot] = start

    def prefill(self, slot, req, chunk, pos, last):
        self.lengths[slot] = pos + len(chunk)

    def decode(self, slots):
        rows = list(slots)
        if self.full is None and len(rows) == self.n_slots:
            self.full = (self.table[rows].copy(), self.lengths[rows].copy())
        self.lengths[rows] += 1

    def evict(self, slot, req):
        self.table[slot] = self.sentinel


def _b6_path_row(G, label, cfg, spec, table, lengths, rate):
    """B6 at a serving path's geometry: the page table and lengths of its
    first full decode tick (``_TickHooks``), a pool of the path's bf16
    pages drawn N(0, 1) on the card and a bf16 q, against its plain
    version within phase 11's tolerance plus one bf16 ulp (``_fd_err``)
    at the size the wrapper chooses and at every cluster size; timed
    (events, device time) beside its bound, the plain version and gather
    + SDPA (``_fd_times``)."""
    gen = torch.Generator(device="cuda").manual_seed(29)
    rows, h, kvh, hd = table.shape[0], cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim
    draw = lambda *sh: torch.randn(*sh, generator=gen, device="cuda").to(
        torch.bfloat16)
    q = draw(rows, h, 1, hd)
    kp = draw(spec.n_pages, spec.page_len, kvh, hd)
    vp = draw(spec.n_pages, spec.page_len, kvh, hd)
    tbl, lens = torch.from_numpy(table).cuda(), torch.from_numpy(
        lengths).cuda()
    got = G.FD.flash_decode_paged(q, kp, vp, tbl, lens)
    want = G.FD.paged_decode_ref(q, kp, vp, tbl, lens)
    torch.cuda.synchronize()
    err, ok, worst = _fd_err(got, want)
    if not ok:
        raise AssertionError(f"flash_decode_paged {label}: kernel differs "
                             f"from its plain version by {err}; worst "
                             f"{worst}")
    rec = {"shape": label, "q": "bfloat16", "cache": "bfloat16", "window": 0,
           "rows": rows, "heads": (h, kvh), "hd": hd,
           "pages": (spec.n_pages, spec.page_len),
           "lengths": [int(x) for x in lengths], "max_abs_err": err}
    rec.update(_fd_splits(G.FD, q, kp, vp, tbl, lens, 0, want, label,
                          timed=False))
    rec.update(_fd_times(G.FD, "flash_decode_paged", q, kp, vp, tbl, lens,
                         None, None, None, 0, lengths, spec.slot_tokens,
                         rate))
    log(f"    B6 {label} ({rows} rows, {h} / {kvh} heads of {hd}, bf16 "
        f"pages of {spec.page_len}, lengths {rec['lengths']}; cluster "
        f"{rec['split']}): {rec['ms'] * 1e3:.1f} us, device "
        f"{rec['device_ms'] * 1e3:.1f} us, bound {rec['bound_ms'] * 1e3:.1f}"
        f" us by {rec['bound_by']} ({rec['bytes'] / 1e6:.1f} MB; "
        f"{rec['bound_ms'] / rec['device_ms']:.0%} of device time), plain "
        f"{rec['plain_ms'] * 1e3:.1f} us, gather + SDPA "
        f"{rec['gather_sdpa_ms'] * 1e3:.1f} us, err {err:.3g}")
    del q, kp, vp
    return rec


def big_serving(G, arch, cfg, params, rate):
    """Phase 25 (f): B6 at the serving path's geometry (``_b6_path_row``
    on the first full tick of the schedule), then phase 12's legs
    (BIG_SERVE_LEGS) through ``serving_phase`` on the params phase 25
    drew, bf16 pages: one B6 launch a layer a decode tick and no plain
    run, the greedy run's tokens those of the first greedy run, the
    sampled leg re-drawn on the CPU.  Returns (records, the legs'
    launches, B6's record)."""
    t0 = time.perf_counter()
    spec = G.PageSpec(**SERVE_SPEC, store_dtype=torch.bfloat16)
    reqs = G.synthetic_workload(0, SERVE_REQUESTS, vocab=cfg.vocab_size,
                                **SERVE_WORKLOAD)
    hooks = _TickHooks(spec)
    G.run_serve_loop(reqs, spec, hooks, prefill_chunk=SERVE_CHUNK)
    row = _b6_path_row(G, f"{arch} serving tick", cfg, spec, *hooks.full,
                       rate)
    rec, path = serving_phase(G, arch, BIG_SERVE_LEGS, cfg=cfg,
                              params=params, store=torch.bfloat16)
    if not rec["paged_repeats_itself"]:
        raise AssertionError(f"{arch} serving: the second greedy run gives "
                             "other tokens than the first")
    rec["wall_s_legs"] = time.perf_counter() - t0
    log(f"  (f) {arch} serving: B6 path row and {len(BIG_SERVE_LEGS)} runs "
        f"in {rec['wall_s_legs']:.1f} s")
    return rec, path, row


def _big_serve_parity(G, cfg, p_card, p_cpu, pair, counted, arch):
    """Phase 25 (e)'s paged-engine leg: phase 13's churn workload (f32
    pages) through the paged engine on the card and on the CPU port, the
    CPU run on the card's expert choices where the model routes
    (``big_parity``'s ``pair``): greedy tokens and schedules identical,
    logits within SERVE_PARITY_BAND, one B6 launch a layer a decode tick
    on the card and nothing else."""
    import numpy as np
    t0 = time.perf_counter()
    spec = G.PageSpec(page_len=16, pages_per_slot=4, n_slots=2)
    reqs = G.synthetic_workload(1, 8, vocab=cfg.vocab_size,
                                prompt_lens=(3, 20), gen_short=(3, 8),
                                gen_long=(12, 20), p_long=0.3)

    def serve(p, device):
        eng = G.ServeEngine(cfg, p, spec=spec, prefill_chunk=8,
                            record_logits=True, device=device)
        return eng.serve(reqs), eng.log, eng.stats["decode_calls"]
    ((rc, clog, calls), n), (rp, plog, _), flips = pair(
        counted(lambda: serve(p_card, "cuda")),
        lambda: serve(p_cpu, "cpu"), f"{arch} reduced paged engine")
    rec = {"tokens_equal": all(a.tokens == b.tokens for a, b in zip(rc, rp)),
           "schedule_equal": clog == plog,
           "logit_gap": max(float(np.abs(x - y).max()) for a, b in
                            zip(rc, rp) for x, y in zip(a.logits, b.logits)),
           "min_margin": min(float(np.diff(np.sort(y)[-2:])[0]) for b in rp
                             for y in b.logits),
           "decode_calls": calls, "launches": n, "routes": flips}
    rec["ok"] = rec["tokens_equal"] and rec["schedule_equal"] and \
        rec["logit_gap"] <= SERVE_PARITY_BAND and \
        n == _big_want(b6=cfg.n_layers * calls)
    log(f"  card vs CPU, reduced paged engine (f32 pages, churn workload): "
        f"tokens identical {rec['tokens_equal']}, schedule identical "
        f"{rec['schedule_equal']}, logit gap {rec['logit_gap']:.3g} (band "
        f"{SERVE_PARITY_BAND:g}), smallest top-2 margin "
        f"{rec['min_margin']:.3g}; {n['flash_decode_paged']} B6 launches "
        f"({cfg.n_layers} x {calls} decode ticks); "
        f"{time.perf_counter() - t0:.1f} s"
        + (f"; routes {flips}" if flips else ""))
    return rec


def big_parity(G, arch):
    """Phase 25 (e): the reduced f32 model (BIG_REDUCED) on the card
    against the CPU port: prefill logits within PREFILL_PARITY_BAND;
    ``generate`` tokens identical and logits within DECODE_PARITY_BAND; a
    long_500k-named shape (window BIG_LONG_WINDOW over BIG_LONG's
    positions) through ``make_decode_step(cfg, shape)``, a chunk then
    one-token steps past the window, logits within DECODE_PARITY_BAND,
    and other logits than the step without the shape.  Arctic's CPU legs
    run on the card's expert choices (``_routed_pair``)."""
    import numpy as np
    cfg = G.replace(G.reduced(G.get_config(arch), **BIG_REDUCED[arch]),
                    attn_window_override=BIG_LONG_WINDOW)
    p_cpu = G.models.init_params(cfg, torch.Generator().manual_seed(3),
                                 device="cpu")
    p_card = G.tree_map(lambda t: t.cuda(), p_cpu)
    rng = np.random.default_rng(5)
    out = {"heads": (cfg.n_heads, cfg.n_kv_heads), "head_dim": cfg.head_dim,
           "d_model": cfg.d_model}

    def pair(card_run, cpu_run, label):
        if cfg.moe:
            card, cpu, _, _, flips = _routed_pair(G, card_run, cpu_run,
                                                  label)
            return card, cpu, flips
        return card_run(), _cpu(cpu_run), None

    def counted(fn):
        def run():
            _reset_dec_counts(G)
            res = fn()
            return res, _dec_counts(G)
        return run
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (2, PREFILL_PARITY_SEQ)))
    prefill = G.make_prefill_step(cfg)
    (card, n), cpu, flips = pair(
        counted(lambda: prefill(p_card, tok.cuda()).cpu()),
        lambda: prefill(p_cpu, tok), f"{arch} reduced prefill")
    out["prefill"] = {"logit_gap": float((card - cpu).abs().max()),
                      "launches": n, "routes": flips}
    plen, gen = DECODE_PARITY_PROMPT, DECODE_PARITY_GEN
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, plen)))
    run = lambda p, t: G.serve.generate(cfg, p, t, gen=gen,
                                        max_seq=plen + gen,
                                        return_logits=True)
    ((ct, cl), gn), (pt, pl), gflips = pair(
        counted(lambda: run(p_card, prompts.cuda())),
        lambda: run(p_cpu, prompts), f"{arch} reduced generate")
    out["generate"] = {"tokens_equal": bool(torch.equal(ct.cpu(), pt)),
                       "logit_gap": float((cl.cpu() - pl).abs().max()),
                       "launches": gn, "routes": gflips}
    shape = G.InputShape(**BIG_LONG)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (2, BIG_LONG_PROMPT + 4)))
    chunks = [(0, BIG_LONG_PROMPT)] + [
        (t, t + 1) for t in range(BIG_LONG_PROMPT, BIG_LONG_PROMPT + 4)]

    def long_run(p, device, windowed=True):
        step = G.make_decode_step(cfg, shape if windowed else None)
        cache = G.models.init_cache(cfg, 2, BIG_LONG["seq_len"],
                                    device=device)
        for a, b in chunks:
            logits, cache = step(p, cache, toks[:, a:b].to(device), a)
        return logits.cpu()
    (lc, ln), lp, lflips = pair(counted(lambda: long_run(p_card, "cuda")),
                                lambda: long_run(p_cpu, "cpu"),
                                f"{arch} reduced long_500k")
    free = long_run(p_card, "cuda", windowed=False)
    out["long_500k"] = {"window": BIG_LONG_WINDOW,
                        "logit_gap": float((lc - lp).abs().max()),
                        "without_override_gap": float((free - lc).abs()
                                                      .max()),
                        "launches": ln, "routes": lflips}
    if arch in BIG_ROWS:
        out["serve"] = _big_serve_parity(G, cfg, p_card, p_cpu, pair,
                                         counted, arch)
    log(f"  card vs CPU, reduced f32 ({cfg.n_heads} / {cfg.n_kv_heads} heads "
        f"of {cfg.head_dim}, d_model {cfg.d_model}, {cfg.n_layers} layers"
        + (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k}"
           if cfg.moe else "") + f"): prefill gap "
        f"{out['prefill']['logit_gap']:.3g} (band {PREFILL_PARITY_BAND:g}); "
        f"generate tokens equal {out['generate']['tokens_equal']}, gap "
        f"{out['generate']['logit_gap']:.3g}; long_500k-named (window "
        f"{BIG_LONG_WINDOW}) gap {out['long_500k']['logit_gap']:.3g} (band "
        f"{DECODE_PARITY_BAND:g}), without the override "
        f"{out['long_500k']['without_override_gap']:.3g} away; launches "
        f"{n} / {gn} / {ln}")
    if not out["prefill"]["logit_gap"] <= PREFILL_PARITY_BAND or \
            n != _big_want(b4=cfg.n_layers) or \
            not out["generate"]["tokens_equal"] or \
            not out["generate"]["logit_gap"] <= DECODE_PARITY_BAND or \
            gn != _big_want(b4=cfg.n_layers,
                            b5=cfg.n_layers * (DECODE_PARITY_GEN - 1)) or \
            not out["long_500k"]["logit_gap"] <= DECODE_PARITY_BAND or \
            ln != _big_want(b4=cfg.n_layers, b5=4 * cfg.n_layers) or \
            not out["long_500k"]["without_override_gap"] > \
            DECODE_PARITY_BAND or not out.get("serve", {"ok": True})["ok"]:
        raise AssertionError(f"{arch} reduced: the card and the CPU port "
                             f"disagree, or the kernels did not run: {out}")
    return out


def big_phase(G, rate):
    """Phase 25: the abstract trees of every config (a), then each of
    llama3-405b, deepseek-67b, arctic-480b and chameleon-34b at full width
    and BIG_LAYERS depth: the prefill (b), decode_32k (c), long_500k (d)
    and, for the BIG_ROWS three, the paged serving engine (f); then the
    reduced four card vs CPU (e), the three through the paged engine too.
    Returns (records, B4, B5 and B6 launches of (b)-(d) and (f), B4's,
    B5's and B6's rows at the BIG_ROWS geometries by kernel)."""
    out = {"abstract": big_abstract(G)}
    launches = {"flash_attention": 0, "flash_decode": 0,
                "flash_decode_paged": 0}
    rows = {"flash_attention": [], "flash_decode": [],
            "flash_decode_paged": []}
    for arch in BIG_LAYERS:
        cfg = G.replace(G.get_config(arch), n_layers=BIG_LAYERS[arch])
        t0 = time.perf_counter()
        params = G.models.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        torch.cuda.synchronize()
        rec = {"layers": cfg.n_layers,
               "full_layers": G.get_config(arch).n_layers,
               "init_s": time.perf_counter() - t0,
               "params": sum(t.numel() for t in G.tree_leaves(params)),
               "weight_bytes": sum(t.numel() * t.element_size()
                                   for t in G.tree_leaves(params))}
        log(f"{arch}: {cfg.n_layers} of {rec['full_layers']} layers at full "
            f"width, {rec['params'] / 1e9:.2f} B params "
            f"({rec['weight_bytes'] / 1e9:.1f} GB bf16), drawn in "
            f"{rec['init_s']:.2f} s; {cfg.n_heads} / {cfg.n_kv_heads} heads "
            f"of {cfg.head_dim}")
        rec["prefill"], n = big_prefill(G, arch, cfg, params)
        launches["flash_attention"] += n["flash_attention"]
        if arch in BIG_ROWS:
            rec["prefill"]["b4"] = _b4_big_row(
                G, arch, cfg, G.SHAPES["prefill_32k"].seq_len, rate)
            rows["flash_attention"].append(rec["prefill"]["b4"])
        gc.collect()
        torch.cuda.empty_cache()
        for shape_name in ("decode_32k", "long_500k"):
            rec[shape_name], n = big_decode(G, arch, cfg, params, shape_name,
                                            rate)
            launches["flash_decode"] += n["flash_decode"]
            if "b5" in rec[shape_name]:
                rows["flash_decode"].append(rec[shape_name]["b5"])
        if arch in BIG_ROWS:
            rec["serving"], path, b6 = big_serving(G, arch, cfg, params,
                                                   rate)
            launches["flash_decode_paged"] += sum(
                path["flash_decode_paged"].values())
            rows["flash_decode_paged"].append(b6)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = rec
    out["parity"] = {arch: big_parity(G, arch) for arch in BIG_LAYERS}
    return out, launches, rows


# phase 26: the dry run of the reference test's pair (tests/test_spmd.py
# test_dryrun_single_combo) on both production meshes, in a process of its
# own (it owns its fake process group); the zamba2 prefill counted twice
DRYRUN_ARGV = ("--arch", GRANITE, "--shape", "decode_32k", "--both-meshes")
DRYRUN_TIMEOUT = 300
COUNT_ARCH = "zamba2-2.7b"


def dryrun_phase(Q):
    """Phase 26: (a) ``python -m repro_torch.launch.dryrun`` on
    ``DRYRUN_ARGV`` in a subprocess: exit 0, "all dry-runs passed", each
    record's per-rank FLOPs, collective bytes by kind and dominant term;
    (b) phase 15's full-width zamba2-2.7b prefill (2 x 2048) counted by
    ``launch.hlo_analysis`` twice, on meta tensors (B4 and B7 by their
    formulas, no launch) and on the card (the kernels launched and counted
    by the same formulas): equal FLOPs and ``dot_bytes_flash``; its median
    CUDA-event ms over 3 calls beside the roofline's ``step_time_s`` on
    one card, and their ratio (printed, not gated); (c) the parity module
    (``engine.parity.check_parity``) on the card.  Returns (records,
    launches per kernel on the card)."""
    import shutil
    import tempfile

    import numpy as np
    out, launches = {}, {}
    # (a)
    rec_dir = tempfile.mkdtemp(prefix="dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    try:
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             *DRYRUN_ARGV, "--out", rec_dir], env=env, cwd=ROOT,
            capture_output=True, text=True, timeout=DRYRUN_TIMEOUT)
        wall = time.perf_counter() - t0
        recs = [json.load(open(os.path.join(rec_dir, f)))
                for f in sorted(os.listdir(rec_dir))]
    finally:
        shutil.rmtree(rec_dir, ignore_errors=True)
    if run.returncode or "all dry-runs passed" not in run.stdout:
        raise AssertionError(f"dry run exit {run.returncode}:\n"
                             f"{run.stdout[-2000:]}\n{run.stderr[-2000:]}")
    out["dryrun"] = {"wall_s": wall, "records": [
        {k: r[k] for k in ("mesh", "n_chips", "t_lower_s",
                           "hlo_flops_per_device",
                           "hlo_dot_bytes_flash_per_device",
                           "collective_bytes_per_device",
                           "collective_by_kind", "collective_counts",
                           "roofline", "kernels")} for r in recs]}
    for r in recs:
        log(f"dry run {GRANITE} x decode_32k x {r['mesh']}: "
            f"{r['hlo_flops_per_device']:.4e} FLOPs a rank, collectives "
            f"{r['collective_by_kind']} bytes ({r['collective_counts']}), "
            f"dominant {r['roofline']['dominant']}, trace {r['t_lower_s']} s")
    log(f"dry run subprocess: {wall:.1f} s, all dry-runs passed")

    # (b)
    cfg = Q.get_config(COUNT_ARCH)
    prefill = Q.make_prefill_step(cfg)
    shape = (PREFILL_BATCH, PREFILL_SEQ)
    with Q.CostCounter() as meta:
        Q.reset_counts()
        prefill(Q.abstract_params(cfg),
                torch.empty(shape, dtype=torch.int64, device="meta"))
        meta_n = Q.meta_counts()
    params = Q.models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, shape)).cuda()
    prefill(params, tokens)                          # warm-up
    torch.cuda.synchronize()
    Q.reset_counts()
    with Q.CostCounter() as card:
        logits = prefill(params, tokens)
        torch.cuda.synchronize()
    counted = Q.counts()
    ms = []
    for _ in range(PREFILL_TIMED):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        a.record()
        prefill(params, tokens)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    launches = Q.counts()["launches"]
    mc, cc = meta.cost, card.cost
    if meta_n != counted["launches"] or counted["launches"] != {
            "flash_attention": 9, "mamba_ssd_scan": 45, "wkv6_chunked": 0}:
        raise AssertionError(f"{COUNT_ARCH} counted prefill: meta "
                             f"{meta_n}, card {counted['launches']}; expected "
                             "9 B4 and 45 B7 each")
    if (mc.flops, mc.dot_bytes_flash) != (cc.flops, cc.dot_bytes_flash) \
            or not cc.flops > 0:
        raise AssertionError(f"{COUNT_ARCH} prefill counts differ: meta "
                             f"{mc.flops} FLOPs / {mc.dot_bytes_flash} "
                             f"bytes, card {cc.flops} / "
                             f"{cc.dot_bytes_flash}")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{COUNT_ARCH} counted prefill: logits not "
                             "finite")
    roof = Q.roofline_terms(
        per_device_flops=cc.flops, per_device_bytes=cc.dot_bytes_flash,
        per_device_collective_bytes=0.0, n_chips=1,
        model_flops=2.0 * cfg.active_param_count() * shape[0] * shape[1])
    med = statistics.median(ms)
    out["count"] = {"arch": COUNT_ARCH, "tokens": list(shape),
                    "flops": cc.flops, "dot_bytes": cc.dot_bytes,
                    "dot_bytes_flash": cc.dot_bytes_flash,
                    "kernels": cc.kernels, "ms": med, "ms_runs": ms,
                    "roofline_step_ms": 1e3 * roof.step_time_s,
                    "dominant": roof.dominant,
                    "share_of_roofline": 1e3 * roof.step_time_s / med,
                    "useful_flops_ratio": roof.useful_flops_ratio}
    log(f"counted prefill {COUNT_ARCH} 2 x 2048: {cc.flops:.6e} FLOPs, "
        f"{cc.dot_bytes_flash:.6e} bytes (flash), equal on meta and on the "
        f"card; kernels {cc.kernels}")
    log(f"  {med:.2f} ms a prefill (CUDA events, median of "
        f"{PREFILL_TIMED}: {[round(t, 2) for t in ms]}) against the "
        f"roofline's {1e3 * roof.step_time_s:.3f} ms ({roof.dominant}): "
        f"{out['count']['share_of_roofline']:.1%} of the roofline")
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()

    # (c)
    Q.K.reset_counts()
    t0 = time.perf_counter()
    par = Q.check_parity(device="cuda")
    out["parity"] = {"wall_s": time.perf_counter() - t0, **par}
    for k in Q.K.KERNEL_VARIANTS:
        launches[k] = Q.K.launch_count(k)
    log(f"parity module on the card (reduced phi3-mini): "
        f"{out['parity']['wall_s']:.1f} s, merge "
        f"{par['merge']['max_param_diff']:.3g}, backend "
        f"{par['backend']['max_param_diff']:.3g}, bf16 backend "
        f"{par['backend_bf16']['max_param_diff']:.3g}; dbl kernels "
        f"{ {k: launches[k] for k in Q.K.KERNEL_VARIANTS} }")
    return out, launches


# --------------------- phase 28: gemma3-4b at full width ---------------------
# gemma3-4b (34 layers: five sliding-window layers of 1,024 keys, then one
# global, so layers 5, 11, 17, 23 and 29 are global; 8 / 4 heads of 256,
# n_rep 2; vocab 262,144) at full width in bf16 on one draw of weights:
# (a) the prefill, phase 15's 2 x 2048 tokens, so the window drops keys on
# the local layers; (b) ``generate`` on 4 x 1,984 prompt tokens + 64
# (max_seq 2,048, the geometry of the gemma3 rows of B5_SHAPES and
# B4_CACHE_SHAPES); (c) the paged engine on 8 requests of 1,100-1,400
# prompt tokens (two lengths, four requests each, so that (b)'s path can
# decode them in two batches) and 32 new tokens each, on bf16 pages of 16,
# 8 slots x 96 pages (1,536 tokens a slot): the one attention segment
# mixes windows, so the step serves every layer through the plain route at
# its own window, as the reference's does, and B6 never runs; (d) reduced
# f32 gemma3 at 6 layers (five local with window 16, then the global one)
# on the card against the CPU port, the 2-layer form's legs of phases 16
# and 21 (c) (both layers local) taken over
GEMMA = "gemma3-4b"
GEMMA_PROMPT, GEMMA_GEN = 1984, 64
GEMMA_SERVE_SPEC = dict(page_len=16, pages_per_slot=96, n_slots=8,
                        store_dtype=torch.bfloat16)
GEMMA_SERVE_PROMPTS, GEMMA_SERVE_NEW = (1100, 1400), 32
# prefill chunks of 128 tokens (phase 12's 64 would double the prefill
# calls; 256 would pad a 1,400-token prompt past the slot's 1,536)
GEMMA_SERVE_CHUNK = 128
GEMMA_SERVE_LEGS = ("paged_recorded", "paged")
GEMMA_PARITY = (("gemma3-4b", 6),)
# B5 at the static decode's first, middle and last one-token step
GEMMA_B5_POSITIONS = (GEMMA_PROMPT, GEMMA_PROMPT + GEMMA_GEN // 2,
                      GEMMA_PROMPT + GEMMA_GEN - 2)


def _gemma_b4_row(D, label, q, k, v, w, off, rate):
    """B4 on one of the path's forms (q contiguous, k / v the ``transpose(1,
    2)`` views of ``(B, S, KV, hd)`` tensors, ``off`` None or a 0-d int32
    offset on the card) against its plain version (PF_F32_TOL plus one
    bf16 ulp), timed beside its bound, its plain version and SDPA on the
    same views."""
    kw = {"window": w} if off is None else {"window": w, "q_offset": off}
    kern = lambda: D.FA.flash_attention(q, k, v, **kw)
    plain = lambda: D.FA.flash_attention_plain(q, k, v, **kw)
    err, ratio = _pf_err("flash_attention", kern(), plain())
    if not ratio <= 1.0:
        raise AssertionError(f"flash_attention {label} window {w}: kernel "
                             f"differs from its plain version by {err} "
                             f"({ratio:.3g} x the tolerance)")
    flops, nbytes = D.FA.flash_attention_work(q, k, v, **kw)
    t_b, t_o = nbytes / rate, flops / BF16_RATE
    o = 0 if off is None else int(off)
    i = o + torch.arange(q.shape[2], device="cuda")
    j = torch.arange(k.shape[2], device="cuda")
    mask = j[None, :] <= i[:, None]
    if w > 0:
        mask &= i[:, None] - j[None, :] < w
    rec = {"shape": label, "dtype": "bfloat16", "window": w,
           "q_offset": o, "q_offset_on": "host" if off is None else "device",
           "max_abs_err": err, "err_over_tol": ratio,
           "ms": cuda_ms(kern), "device_ms": device_ms(kern),
           "plain_ms": cuda_ms(plain, per_group=3, groups=3, warmup=1),
           "bound_ms": 1e3 * max(t_b, t_o),
           "bound_by": "bytes" if t_b >= t_o else "operations",
           "flops": flops, "bytes": nbytes,
           "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=mask, enable_gqa=True))}
    log(f"    flash_attention {label}, window {w}: kernel "
        f"{rec['ms'] * 1e3:.1f} us (device {rec['device_ms'] * 1e3:.1f}), "
        f"plain {rec['plain_ms'] * 1e3:.1f} us, SDPA "
        f"{rec['library_ms'] * 1e3:.1f} us, bound "
        f"{rec['bound_ms'] * 1e3:.1f} us by {rec['bound_by']} "
        f"({rec['bound_ms'] / rec['device_ms']:.0%} of device time), err "
        f"{err:.3g} ({ratio:.2f} x the tolerance)")
    return rec


def gemma_kernel_rows(D, rate):
    """Phase 28, before the legs: B4 and B5 at the path's own geometry in
    bf16, windowed (1,024) and global, each against its plain version and
    timed (``_gemma_b4_row``; B5 by ``_b5_time`` beside its plain version
    and SDPA): B4 on (a)'s 2 x 2048 prefill (k / v views of the
    projections' layout), B4 on (b)'s 1,984-token chunk at a device offset
    of 0 over the 2,048-key cache views, B5 at (b)'s first, middle and
    last decode positions over those views, the position on the card.
    Returns the records by kernel."""
    cfg = D.get_config(GEMMA)
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    windows = (cfg.attn_window, 0)
    max_seq = GEMMA_PROMPT + GEMMA_GEN
    gen = torch.Generator(device="cuda").manual_seed(2800)
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16)
    out = {"flash_attention": [], "flash_decode": []}
    q = rn(PREFILL_BATCH, h, PREFILL_SEQ, hd)
    k, v = (rn(PREFILL_BATCH, PREFILL_SEQ, kvh, hd).transpose(1, 2)
            for _ in "kv")
    for w in windows:
        out["flash_attention"].append(_gemma_b4_row(
            D, f"{GEMMA} prefill", q, k, v, w, None, rate))
    q = rn(DEC_BATCH, h, GEMMA_PROMPT, hd)
    k, v = (rn(DEC_BATCH, max_seq, kvh, hd).transpose(1, 2) for _ in "kv")
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    for w in windows:
        out["flash_attention"].append(_gemma_b4_row(
            D, f"{GEMMA} static prefill cache view", q, k, v, w, zero, rate))
    q = rn(DEC_BATCH, h, 1, hd)
    for w in windows:
        for pos in GEMMA_B5_POSITIONS:
            on_card = torch.tensor(pos, dtype=torch.int32, device="cuda")
            ref = D.FD._xla_decode(q, k, v, pos, window=w)
            err, ok, worst = _fd_err(
                D.FD.flash_decode(q, k, v, on_card, window=w), ref)
            if not ok:
                raise AssertionError(f"flash_decode {GEMMA} static pos {pos} "
                                     f"window {w}: kernel differs from its "
                                     f"plain version by {err}; worst {worst}")
            idx = torch.arange(max_seq, device="cuda")
            lo = max(0, pos - w + 1) if w > 0 else 0
            mask = ((idx <= pos) & (idx >= lo))[None, None, None]
            rec = {"shape": f"{GEMMA} static path", "q": "bfloat16",
                   "cache": "bfloat16", "layout": "(B, S, KV, hd)",
                   "pos": pos, "window": w, "max_abs_err": err,
                   **_b5_time(D.FD, q, k, v, pos, w, rate),
                   "plain_ms": cuda_ms(lambda: D.FD._xla_decode(
                       q, k, v, pos, window=w)),
                   "library_ms": cuda_ms(
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, attn_mask=mask, enable_gqa=True))}
            out["flash_decode"].append(rec)
            log(f"    flash_decode {GEMMA} static path, pos {pos}, window "
                f"{w}: kernel {rec['ms'] * 1e3:.1f} us (device "
                f"{rec['device_ms'] * 1e3:.1f}, pos on the card "
                f"{rec['device_ms_pos_on_card'] * 1e3:.1f}), plain "
                f"{rec['plain_ms'] * 1e3:.1f} us, SDPA "
                f"{rec['library_ms'] * 1e3:.1f} us, bound "
                f"{rec['bound_ms'] * 1e3:.2f} us by {rec['bound_by']} "
                f"({rec['bound_ms'] / rec['device_ms_pos_on_card']:.0%} of "
                f"device time), err {err:.3g}")
    del q, k, v
    torch.cuda.empty_cache()
    return out


def _gemma_requests(G, cfg):
    """(c)'s 8 requests: two prompt lengths in GEMMA_SERVE_PROMPTS, four
    requests each (seeded random tokens), GEMMA_SERVE_NEW new tokens each,
    one arriving every other tick."""
    import numpy as np
    rng = np.random.default_rng(28)
    lens = rng.integers(GEMMA_SERVE_PROMPTS[0], GEMMA_SERVE_PROMPTS[1] + 1, 2)
    return [G.Request(rid=i, tokens=tuple(int(t) for t in rng.integers(
                0, cfg.vocab_size, int(lens[i % 2]))),
                      max_new=GEMMA_SERVE_NEW, arrival=2 * i)
            for i in range(8)]


def _static_agreement(G, cfg, params, reqs, tokens):
    """(b)'s path, ``generate``, on (c)'s prompts, a batch per prompt
    length: the share of (c)'s tokens it gives too, position by position,
    and each request's first position that differs (bf16 logits can tie,
    and one tie parts the streams: reported, not asserted)."""
    agree, first = [], {}
    for n in sorted({len(r.tokens) for r in reqs}):
        group = [r for r in reqs if len(r.tokens) == n]
        prompts = torch.tensor([r.tokens for r in group], device="cuda")
        toks = G.serve.generate(cfg, params, prompts, gen=GEMMA_SERVE_NEW,
                                max_seq=n + GEMMA_SERVE_NEW)[:, n:].tolist()
        for r, t in zip(group, toks):
            same = [a == b for a, b in zip(t, tokens[r.rid])]
            agree += same
            first[r.rid] = same.index(False) if False in same else None
    return {"token_agreement": sum(agree) / len(agree),
            "first_difference": first}


def gemma_phase(G, rate):
    """Phase 28: gemma3-4b at full width on one H100 (module comment
    above): B4 and B5 at the path's own geometry (``gemma_kernel_rows``);
    one draw of bf16 weights on the card for (a) ``prefill_phase`` (34 B4
    a forward), (b) ``decode_phase`` (34 B4 in the chunked prefill, 34 x
    63 B5, ``pos`` on the card) and (c) ``serving_phase`` (the mixed
    segment's plain route at each layer's window in every tick, no B6;
    token agreement with (b)'s path reported), freed after; (d) the
    reduced 6-layer form on the card against the CPU port through phases
    16, 21 (c) and 13's legs.  Returns (records, launches per kernel on
    the full-width paths, the kernel rows)."""
    rows = gemma_kernel_rows(G, rate)
    cfg = G.get_config(GEMMA)
    segs = G.layout(cfg)
    windows = [w for s in segs for w in s.windows]
    global_layers = [i for i, w in enumerate(windows) if w == 0]
    if len(segs) != 1 or len(windows) != 34 or \
            global_layers != [5, 11, 17, 23, 29]:
        raise AssertionError(f"{GEMMA}: segments {segs}")
    t0 = time.perf_counter()
    params = G.models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    out = {"layers": len(windows), "global_layers": global_layers,
           "window": cfg.attn_window, "init_s": time.perf_counter() - t0,
           "params": sum(t.numel() for t in G.tree_leaves(params)),
           "weight_bytes": sum(t.numel() * t.element_size()
                               for t in G.tree_leaves(params))}
    log(f"{GEMMA} full width: {out['params'] / 1e9:.2f} B params "
        f"({out['weight_bytes'] / 1e9:.2f} GB bf16) drawn in "
        f"{out['init_s']:.2f} s; {len(windows)} layers in one attention "
        f"segment, global {global_layers}, the rest window "
        f"{cfg.attn_window}")
    out["prefill"], pf = prefill_phase(G, archs=(GEMMA,), params=params)
    out["decode"], dl = decode_phase(G, archs=(GEMMA,), params=params,
                                     prompt=GEMMA_PROMPT, gen_full=GEMMA_GEN)
    reqs = _gemma_requests(G, cfg)
    out["serving"], sl = serving_phase(
        G, GEMMA, legs=GEMMA_SERVE_LEGS, cfg=cfg, params=params, reqs=reqs,
        spec=G.PageSpec(**GEMMA_SERVE_SPEC), chunk=GEMMA_SERVE_CHUNK)
    agree = _static_agreement(G, cfg, params, reqs, out["serving"]["tokens"])
    out["serving"]["static_path"] = agree
    log(f"  (c) against (b)'s path (generate on the same prompts, a batch "
        f"per prompt length): {agree['token_agreement']:.1%} of the tokens "
        f"agree; first difference by request {agree['first_difference']} "
        "(reported, not asserted)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["parity"] = {
        "prefill": prefill_parity_phase(G, archs=GEMMA_PARITY),
        "decode": decode_parity_phase(G, archs=GEMMA_PARITY, sampled=False),
        "serve": serve_parity_phase(G, archs=GEMMA_PARITY,
                                    card_features=False)}
    launches = {"flash_attention": pf["flash_attention"]
                + dl["flash_attention"],
                "flash_decode": dl["flash_decode"],
                "flash_decode_paged": sum(sl["flash_decode_paged"].values())}
    if launches["flash_decode_paged"]:
        raise AssertionError(f"{GEMMA} serving launched B6: {launches}")
    out["launches"] = launches
    return out, launches, rows


# the phases that stand alone, without the records of the phases before
# them: ``--phases`` runs a list of them after the build (phase 1)
STANDALONE = (23, 25, 26, 27, 28)


def port_names():
    """The port's modules as each group of phases reads them (S: serving,
    P: prefill, L: LM training, D: static decode, M: the MoE family, E:
    the encoder-decoder, G: the remaining configs, GM: gemma3, Q: the dry
    run), imported once CUDA is known."""
    from dataclasses import replace
    from types import SimpleNamespace

    from repro_torch import api, models
    from repro_torch import serve as serve_pkg
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config, reduced
    from repro_torch.configs.base import InputShape
    from repro_torch.core import prng
    from repro_torch.core.flat import flat_spec
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data import DataPlane, SyntheticTokens
    from repro_torch.engine import TrainEngine
    from repro_torch.engine.parity import check_parity
    from repro_torch.kernels import dbl_merge as K
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import mamba_scan as SSD
    from repro_torch.kernels import ops as ops_mod
    from repro_torch.kernels import wkv6 as WKV
    from repro_torch.kernels.ref import dbl_merge_ref
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import specs as specs_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.hlo_analysis import CostCounter, roofline_terms
    from repro_torch.launch.specs import abstract_params
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step, make_train_step)
    from repro_torch.models import encdec as encdec_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf_mod
    from repro_torch.models.transformer import layout
    from repro_torch.optim import make_optimizer, sgd_momentum
    from repro_torch.serve import paged
    pf_mods = {"flash_attention": FA, "mamba_ssd_scan": SSD,
               "wkv6_chunked": WKV}

    def reset_pf():
        for mod in pf_mods.values():
            mod.reset_counts()

    def pf_counts():
        return {"launches": {k: mod.launch_count(k)
                             for k, mod in pf_mods.items()},
                "plain": sum(mod.plain_count() for mod in pf_mods.values())}
    S = SimpleNamespace(FD=FD, models=models, get_config=get_config,
                        reduced=reduced, tree_leaves=tree_leaves,
                        tree_map=tree_map, prng=prng, paged=paged,
                        **{n: getattr(serve_pkg, n)
                           for n in serve_pkg.__all__})
    P = SimpleNamespace(FA=FA, SSD=SSD, WKV=WKV, FD=FD, ops=ops_mod,
                        models=models,
                        get_config=get_config, reduced=reduced, layout=layout,
                        tree_leaves=tree_leaves, tree_map=tree_map,
                        make_prefill_step=make_prefill_step,
                        reset_counts=reset_pf, counts=pf_counts,
                        dbl_merge_ref=dbl_merge_ref)
    L = SimpleNamespace(K=K, pf_mods=tuple(pf_mods.values()),
                        train=train_mod, models=models, api=api,
                        get_config=get_config, reduced=reduced,
                        flat_spec=flat_spec, tree_leaves=tree_leaves,
                        tree_map=tree_map, DataPlane=DataPlane,
                        SyntheticTokens=SyntheticTokens,
                        TrainEngine=TrainEngine, sgd_momentum=sgd_momentum,
                        make_optimizer=make_optimizer)
    D = SimpleNamespace(FD=FD, FA=FA, SSD=SSD, WKV=WKV, models=models,
                        get_config=get_config, reduced=reduced, layout=layout,
                        tree_leaves=tree_leaves, tree_map=tree_map,
                        serve=serve_launch, ServeEngine=S.ServeEngine,
                        PageSpec=S.PageSpec, Request=S.Request, prng=prng,
                        paged=paged,
                        repetitive_workload=S.repetitive_workload)
    M = SimpleNamespace(**{**vars(S), **vars(P), **vars(D), **vars(L)},
                        moe=moe_mod, transformer=tf_mod)
    E = SimpleNamespace(**vars(D), encdec=encdec_mod,
                        make_prefill_step=make_prefill_step,
                        make_decode_step=make_decode_step,
                        make_train_step=make_train_step,
                        sgd_momentum=sgd_momentum)
    G = SimpleNamespace(**{**vars(S), **vars(E)}, ARCH_IDS=ARCH_IDS,
                        SHAPES=SHAPES,
                        InputShape=InputShape, specs=specs_mod,
                        replace=replace, moe=moe_mod, transformer=tf_mod)
    GM = SimpleNamespace(**{**vars(S), **vars(P), **vars(D)})
    Q = SimpleNamespace(**vars(P), K=K, CostCounter=CostCounter,
                        roofline_terms=roofline_terms,
                        abstract_params=abstract_params,
                        check_parity=check_parity,
                        meta_counts=lambda: {k: mod.meta_count(k)
                                             for k, mod in pf_mods.items()})
    return SimpleNamespace(S=S, P=P, L=L, D=D, M=M, E=E, G=G, GM=GM, Q=Q,
                           pf_mods=pf_mods)


def run_selected(phases, N, rate, name, report, out_path):
    """``--phases``: the listed phases of STANDALONE after the build, each
    as the whole run drives it; prints the nvidia-smi line, one JSON line
    of what each phase returns beside its records (its launches and
    kernel rows), and a last line naming the phases that ran (it never
    stands for a whole run)."""
    runs = {23: lambda: spmd_phase(_spmd_names(), rate),
            25: lambda: big_phase(N.G, rate),
            26: lambda: dryrun_phase(N.Q),
            27: lambda: rwkv_train_phase(N.L, rate),
            28: lambda: gemma_phase(N.GM, rate)}
    t0, returned = time.perf_counter(), {}
    for n in phases:
        gc.collect()
        torch.cuda.empty_cache()
        res = runs[n]()
        report[f"phase {n}"], returned[str(n)] = res[0], res[1:]
        log(f"[{time.perf_counter() - t0:.0f} s] phase {n} done")
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"phases": returned}, default=str), flush=True)
    print(json.dumps({"ok": True, "phases": [1, *phases], "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _phase_list(ap, text):
    """``--phases``' list: 1 (the build, which always runs) and phases of
    STANDALONE, in the order given."""
    try:
        got = [int(x) for x in text.split(",") if x.strip()]
    except ValueError:
        got = None
    if not got or any(n != 1 and n not in STANDALONE for n in got):
        ap.error(f"--phases takes a comma-separated list of 1 and phases "
                 f"of {STANDALONE}, not {text!r}")
    return [n for n in dict.fromkeys(got) if n != 1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--phases", metavar="LIST", default=None,
                    help="only build the kernels (phase 1) and run these "
                    f"of the phases that stand alone, {STANDALONE}, in "
                    "order (e.g. 1,28)")
    ap.add_argument("--b5-times", metavar="SRC", default=None,
                    help="only time B5 (flash_decode) from the port under "
                    "SRC (a directory holding repro_torch, e.g. a parent "
                    "commit's src), print the records and stop")
    args = ap.parse_args()
    phases = None if args.phases is None else _phase_list(ap, args.phases)
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    src = args.b5_times or os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no repro_torch under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    if args.b5_times:
        from repro_torch.kernels import flash_decode as FD
        name = torch.cuda.get_device_name(0)
        log(f"B5 from {os.path.abspath(src)} on {name}")
        recs = b5_times(FD, mem_rate(name))
        print(nvidia_smi_line(), flush=True)
        print(json.dumps({"src": src, "b5": recs}), flush=True)
        return 0
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
    N = port_names()
    if phases is not None:
        return run_selected(phases, N, rate, name, report, args.out)

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
    S, P, L, D = N.S, N.P, N.L, N.D
    fd_recs = fd_kernel_phase(S.FD, rate)
    log(f"[{time.perf_counter() - t_start:.0f} s] B5/B6 checked")

    # 12. the serving main path at full width, then 13. card vs CPU
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
    gc.collect()
    torch.cuda.empty_cache()
    # one timed step a sub-stage (3 until phase 25's serving needed the
    # time)
    report["lm_train"], b1_store = lm_train_phase(L, rate, runs=1)
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

    # 21. the static decode: B5 on the strided layer cache and B4's query
    # offset against their plain versions, the full-width decode paths,
    # card vs CPU
    gc.collect()
    torch.cuda.empty_cache()
    b5_recs = b5_static_phase(D, rate)
    b4_recs = b4_offset_phase(D, rate) + b4_cache_phase(D, rate)
    log(f"[{time.perf_counter() - t_start:.0f} s] B5 strided / B4 offset "
        "checked")
    report["decode"], dec_launches = decode_phase(D)
    log(f"[{time.perf_counter() - t_start:.0f} s] static decode main path "
        "done")
    report["decode_parity"] = decode_parity_phase(D)
    log(f"[{time.perf_counter() - t_start:.0f} s] decode parity done")
    # B5's line: the static decode path's form (phi3 geometry, bf16 q and
    # (B, S, KV, hd) cache), its launches those of phase 21 (b); B4 adds
    # its chunked prefills there to phase 15's count
    b5 = next(entry for entry in line if entry["name"] == "flash_decode")
    main = next(r for r in b5_recs if r["shape"] == B5_SHAPES[0][0] and
                r["q"] == "bfloat16" and r["cache"] == "bfloat16" and
                "ms" in r)
    b5.update({k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")})
    b5["launches"] = dec_launches["flash_decode"]
    b5["variants"].extend(b5_recs)
    b4 = next(entry for entry in line if entry["name"] == "flash_attention")
    b4["launches"] += dec_launches["flash_attention"]
    b4["variants"].extend(b4_recs)
    for entry in (b4, b5):
        entry["max_abs_err"] = max(r["max_abs_err"]
                                   for r in entry["variants"])

    # 22. the MoE family: granite-moe-3b-a800m at full width on every LM
    # path (its kernel geometries ran in phases 11, 14 and 21), then card
    # vs CPU
    report["moe"], moe_launches, b1_granite = moe_phase(N.M, rate)
    log(f"[{time.perf_counter() - t_start:.0f} s] MoE family done")
    # granite's kernel records among the line's variants (phases 11, 14
    # and 21)
    report["moe"]["kernels"] = {
        e["name"]: [r for r in e["variants"]
                    if r.get("shape", "").startswith(GRANITE)]
        for e in line if e["name"] in ("flash_attention", "flash_decode",
                                       "flash_decode_paged")}
    report["moe"]["launches"] = moe_launches
    for entry in line:
        n = moe_launches.get(entry["name"], 0)
        entry["launches"] += n
    line[0]["variants"][0]["launches"] += moe_launches["dbl_apply_flat2d"]
    b1_granite["launches"] = \
        report["moe"]["lm_train"]["launches"]["dbl_apply_flat2d"]
    line[0]["variants"].append(b1_granite)
    line[0]["max_abs_err"] = max(line[0]["max_abs_err"],
                                 b1_granite["max_abs_err"])

    # 23. multi-GPU SPMD on one NCCL rank: B2's leafwise form, the mesh
    # main path at full width, mesh against no mesh, card against a
    # 4-rank gloo CPU mesh
    gc.collect()
    torch.cuda.empty_cache()
    report["spmd"], b2_leafwise = spmd_phase(_spmd_names(), rate)
    log(f"[{time.perf_counter() - t_start:.0f} s] SPMD done")
    # B2's line: the leafwise form, the one this slice's main path runs;
    # the flat-store records stay among its variants
    b2 = next(entry for entry in line if entry["name"] == "dbl_merge_flat2d")
    b2["variants"].append(b2_leafwise)
    b2["launches"] += b2_leafwise["launches"]
    b2.update({k: b2_leafwise[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")})

    # 24. the encoder-decoder family: seamless-m4t-large-v2 at full width
    # on the prefill, static decode and training paths (its kernel
    # geometries ran in phases 14 and 21), then card vs CPU
    gc.collect()
    torch.cuda.empty_cache()
    report["encdec"], encdec_launches = encdec_phase(N.E)
    log(f"[{time.perf_counter() - t_start:.0f} s] encoder-decoder done")
    report["encdec"]["kernels"] = {
        e["name"]: [r for r in e["variants"]
                    if r.get("shape", "").startswith(SEAMLESS)]
        for e in line if e["name"] in ("flash_attention", "flash_decode")}
    report["encdec"]["launches"] = encdec_launches
    for entry in line:
        entry["launches"] += encdec_launches.get(entry["name"], 0)

    # 25. the remaining configs: llama3-405b, deepseek-67b, arctic-480b and
    # chameleon-34b at full width and cut depth through the reference's
    # input shapes (their kernel geometries ride in phases 11, 14 and 21),
    # then card vs CPU
    gc.collect()
    torch.cuda.empty_cache()
    report["big"], big_launches, big_rows = big_phase(N.G, rate)
    log(f"[{time.perf_counter() - t_start:.0f} s] remaining configs done")
    report["big"]["kernels"] = {
        e["name"]: [r for r in e["variants"]
                    if r.get("shape", "").split(" ")[0] in BIG_LAYERS]
        for e in line if e["name"] in ("flash_attention", "flash_decode",
                                       "flash_decode_paged")}
    report["big"]["launches"] = big_launches
    for entry in line:
        entry["launches"] += big_launches.get(entry["name"], 0)
    for entry in line:
        if entry["name"] in big_rows:
            entry["variants"].extend(big_rows[entry["name"]])
            entry["max_abs_err"] = max(r["max_abs_err"]
                                       for r in entry["variants"])

    # 26. the dry run on the production meshes (a subprocess), the zamba2
    # prefill counted on meta tensors and on the card, the parity module
    # on the card
    gc.collect()
    torch.cuda.empty_cache()
    report["dryrun"], dry_launches = dryrun_phase(N.Q)
    log(f"[{time.perf_counter() - t_start:.0f} s] dry run and counts done")
    for entry in line:
        entry["launches"] += dry_launches.get(entry["name"], 0)

    # 27. rwkv6-7b LM training at 4,096 tokens: one layer's saved memory
    # with the chunked WKV scan, the training main path at full width and
    # cut depth, card vs CPU over four chunks
    gc.collect()
    torch.cuda.empty_cache()
    report["rwkv_train"], rwkv_b1, b1_rwkv = rwkv_train_phase(L, rate)
    log(f"[{time.perf_counter() - t_start:.0f} s] rwkv6 training done")
    line[0]["launches"] += rwkv_b1
    line[0]["variants"][0]["launches"] += rwkv_b1
    b1_rwkv["launches"] = \
        report["rwkv_train"]["launches"]["dbl_apply_flat2d"]
    line[0]["variants"].append(b1_rwkv)
    line[0]["max_abs_err"] = max(line[0]["max_abs_err"],
                                 b1_rwkv["max_abs_err"])

    # 28. gemma3-4b at full width: B4 and B5 at its path's geometry, the
    # prefill, the static decode and the paged engine on one draw of
    # weights, then its reduced 6-layer form card vs CPU
    gc.collect()
    torch.cuda.empty_cache()
    report["gemma"], gemma_launches, gemma_rows = gemma_phase(N.GM, rate)
    log(f"[{time.perf_counter() - t_start:.0f} s] gemma3-4b done")
    for entry in line:
        entry["launches"] += gemma_launches.get(entry["name"], 0)
        if entry["name"] in gemma_rows:
            entry["variants"].extend(gemma_rows[entry["name"]])
            entry["max_abs_err"] = max(r["max_abs_err"]
                                       for r in entry["variants"])
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
