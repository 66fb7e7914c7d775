"""Serving from the command line: static batching (``generate``) or
continuous batching through ``ServeEngine``.

Static batching (``--engine static``, the default) runs one fixed batch
to completion through ``generate``.  Its prefill is ONE chunked decode
call for attention archs — the whole prompt enters the KV cache at once
(B4 with its query offset in every layer on the card) — and steps token
by token for recurrent state (mamba2 / rwkv6), which has no cache to
chunk into; every generated token is one decode step (B5 in every
attention layer on the card, reading the step's position from the
device).  ``generate(greedy=False, rng=key)`` samples as the
reference's does, one threefry key ``fold_in(rng, t)`` a step over the
whole batch (``core.prng``); the CLI's static engine stays greedy whatever
``--temperature`` says, as the reference's CLI does (it never passes
``greedy=False``; ROADMAP C14).

``--engine continuous`` hands a synthetic request stream to
``repro_torch.serve.ServeEngine``: paged KV cache, admission the moment
pages free up, chunked prefill interleaved with in-flight decode, and on
the card the hand-written paged decode kernel in every layer of every
one-token decode tick.  ``--spec-k`` turns on draft-free speculative
decode (n-gram prompt lookup, greedy only) and ``--prefix-share``
copy-on-write prefix sharing; ``--temperature``/``--top-k`` sample each
token in the step, keyed on (``--seed``, request, step) as the
reference's engine does.

As the reference's CLI, ``--reduced`` is on by default (``store_true``
with default ``True``), so the CLI always serves the reduced model; a
full-width run calls ``generate`` or ``ServeEngine`` directly
(``chip_smoke.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \\
      --batch 4 --prompt-len 32 --gen 16 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \\
      --requests 16 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \\
      --temperature 0.8 --top-k 40
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
from repro_torch.configs.base import MAMBA2, RWKV6
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step


def chunkable(cfg) -> bool:
    """Whole-prompt (T = P) prefill works iff every layer carries a KV
    cache — recurrent segments must consume tokens one step at a time."""
    if cfg.encoder_layers:
        return False
    from repro_torch.models.transformer import layout
    return all(s.kind not in (MAMBA2, RWKV6) for s in layout(cfg))


def generate(cfg, params, prompts, *, gen: int, max_seq: int, greedy=True,
             rng=None, stepped_prefill: bool = False,
             return_logits: bool = False):
    """prompts: (B, P) int tensor on the params' device.  Returns (B, P +
    gen) tokens in the prompts' dtype (and, with ``return_logits``, the
    (B, gen, V) logits each generated token was chosen from).

    Attention archs prefill in ONE chunked decode call; recurrent archs
    and the encoder-decoder — or ``stepped_prefill=True`` — step token by
    token (the encoder-decoder over the zero ``enc_out`` of a fresh cache,
    as the reference's).  Every call, the chunked prefill's too, takes its
    position from one int32 tensor on the prompts' device (0 for the
    prefill, as the reference's ``jnp.int32(0)``), advanced in place after
    the call, as the reference passes a traced ``jnp.int32(t)``: B4 and
    B5 read it there, so each step launches its kernels with the same
    arguments.

    ``greedy=False`` samples token ``t`` (its absolute position) with
    ``categorical(fold_in(rng, t), logits)`` (``core.prng``), one key over
    the whole ``(B, V)`` batch and the noise in the logits' own dtype, as
    the reference's ``jax.random`` call does; ``rng`` is a key from
    ``prng.PRNGKey``.  The loop reads nothing back from the card until the
    end: each step's token is chosen on the device, and the keys are
    derived there once, before the first step."""
    b, p = prompts.shape
    if not greedy:
        if rng is None:
            raise ValueError("sampled generation (greedy=False) needs rng, "
                             "a key from core.prng.PRNGKey")
        keys = prng.fold_in(rng.to(prompts.device), torch.arange(
            p, p + gen, device=prompts.device))
    cache = models.init_cache(cfg, b, max_seq, device=prompts.device)
    decode = make_decode_step(cfg)
    pos = torch.zeros((), dtype=torch.int32, device=prompts.device)
    if stepped_prefill or not chunkable(cfg):
        # prefill by stepping (the only correct path for recurrent state)
        for t in range(p):
            logits, cache = decode(params, cache, prompts[:, t:t + 1], pos)
            pos.add_(1)
    else:
        logits, cache = decode(params, cache, prompts, pos)
        pos.add_(p)
    out, seen = [prompts], []
    for i, t in enumerate(range(p, p + gen)):
        seen.append(logits)
        pick = (torch.argmax(logits, dim=-1) if greedy
                else prng.categorical(keys[i], logits))
        nxt = pick.to(prompts.dtype)[:, None]
        out.append(nxt)
        if t < p + gen - 1:
            logits, cache = decode(params, cache, nxt, pos)
            pos.add_(1)
    toks = torch.cat(out, dim=1)
    return (toks, torch.stack(seen, dim=1)) if return_logits else toks


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
                    help="sampling temperature of the continuous engine "
                         "(0 = greedy; incompatible with --spec-k); the "
                         "static engine ignores it and decodes greedily, "
                         "as the reference's CLI does")
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
    if cfg.encoder_layers:
        raise SystemExit("use python -m repro_torch.examples.serve_decode "
                         "for enc-dec archs")
    if args.engine == "static" and args.temperature > 0:
        print(f"note: --engine static decodes greedily; --temperature "
              f"{args.temperature:g} applies to --engine continuous only "
              "(as in the reference's CLI)")
    dev = resolve_device(args.device)
    params = models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    if args.engine == "continuous":
        return _serve_continuous(cfg, params, args)

    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator().manual_seed(args.seed)).to(dev)
    t0 = time.time()
    toks = generate(cfg, params, prompts, gen=args.gen,
                    max_seq=args.prompt_len + args.gen,
                    stepped_prefill=args.stepped_prefill)
    sample = toks[0, :24].tolist()          # ends in the sync
    dt = time.time() - t0
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} on {dev}: {args.batch * args.gen / dt:.1f} tok/s "
          f"({dt:.1f}s)")
    print("sample:", sample)
    return toks


if __name__ == "__main__":
    run()
