"""Serving from the command line: continuous batching through ``ServeEngine``.

``--engine continuous`` hands a synthetic request stream to
``repro_torch.serve.ServeEngine``: paged KV cache, admission the moment
pages free up, chunked prefill interleaved with in-flight decode, and on
the card the hand-written paged decode kernel in every layer of every
one-token decode tick.  ``--spec-k`` turns on draft-free speculative
decode (n-gram prompt lookup, greedy only) and ``--prefix-share``
copy-on-write prefix sharing.  ``--temperature``/``--top-k`` sampling
and the static ``generate`` path (``--engine static``) are not ported
yet and raise, naming their ROADMAP items (A18, A12).

As the reference's CLI, ``--reduced`` is on by default (``store_true``
with default ``True``), so the CLI always serves the reduced model; a
full-width run goes through ``ServeEngine`` directly (``chip_smoke.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \\
      --requests 16 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \\
      --workload repetitive --spec-k 3
  PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \\
      --workload shared-prefix --prefix-share
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.device import resolve_device


def _serve_continuous(cfg, params, args):
    from repro_torch.serve import (PageSpec, ServeEngine, repetitive_workload,
                                   shared_prefix_workload, synthetic_workload)
    spec = PageSpec(page_len=args.page_len, pages_per_slot=args.pages_per_slot,
                    n_slots=args.slots)
    engine = ServeEngine(cfg, params, spec=spec,
                         prefill_chunk=args.prefill_chunk,
                         spec_k=args.spec_k,
                         temperature=args.temperature, top_k=args.top_k,
                         sample_seed=args.seed,
                         prefix_share=args.prefix_share,
                         device=args.device)
    if args.workload == "repetitive":
        reqs = repetitive_workload(args.seed, args.requests,
                                   vocab=cfg.vocab_size,
                                   prompt_len=args.prompt_len,
                                   gen=(args.gen, args.gen + 8))
    elif args.workload == "shared-prefix":
        reqs = shared_prefix_workload(args.seed, args.requests,
                                      vocab=cfg.vocab_size,
                                      gen=(args.gen, args.gen + 8))
    else:
        reqs = synthetic_workload(args.seed, args.requests,
                                  vocab=cfg.vocab_size,
                                  prompt_lens=(4, args.prompt_len),
                                  gen_long=(args.gen, args.gen + 8))
    t0 = time.time()
    recs = engine.serve(reqs)
    dt = time.time() - t0
    n_tok = sum(len(r.tokens) for r in recs)
    ttft = np.mean([r.ttft_s for r in recs])
    print(f"arch={cfg.name} continuous requests={len(recs)} "
          f"slots={spec.n_slots} pages={spec.n_pages}x{spec.page_len} on "
          f"{engine.device}: {n_tok / dt:.1f} tok/s  mean TTFT "
          f"{ttft * 1e3:.1f}ms ({engine.stats['decode_calls']} decode / "
          f"{engine.stats['prefill_calls']} prefill calls)")
    if args.spec_k:
        print(f"  speculative k={args.spec_k}: accept rate "
              f"{engine.accept_rate:.3f} "
              f"({engine.stats['draft_accepted']}/"
              f"{engine.stats['draft_proposed']} drafts, "
              f"{engine.stats['spec_dispatches']} verify dispatches)")
    if args.prefix_share:
        print(f"  prefix sharing: skipped "
              f"{engine.prefill_skip_frac:.1%} of prompt tokens "
              f"({engine.stats['prefill_skipped_tokens']}/"
              f"{engine.stats['prompt_tokens']}, "
              f"{engine.stats['cow_copies']} COW page copies)")
    return recs


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="gemma3-4b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--engine", choices=("static", "continuous"),
                    default="static")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stepped-prefill", action="store_true",
                    help="force token-by-token prefill on attention archs")
    # continuous-engine knobs
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-len", type=int, default=16)
    ap.add_argument("--pages-per-slot", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--workload",
                    choices=("synthetic", "repetitive", "shared-prefix"),
                    default="synthetic")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decode: n-gram draft length "
                         "(0 = one-token decode; greedy only)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy; "
                         "incompatible with --spec-k)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation for sampled decode (0 = full)")
    ap.add_argument("--prefix-share", action="store_true",
                    help="COW prefix sharing across admitted prompts")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.engine == "static":
        raise NotImplementedError(
            "--engine static needs the static generate path "
            "(launch/steps.py, transformer.forward / decode_step), which "
            "waits for ROADMAP A12; use --engine continuous")
    dev = resolve_device(args.device)
    params = models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    return _serve_continuous(cfg, params, args)


if __name__ == "__main__":
    run()
