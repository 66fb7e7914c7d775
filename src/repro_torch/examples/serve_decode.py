"""Serving example on the port: batched generation across architecture
families — KV-cache decode (dense/GQA + sliding window), recurrent-state
decode (Mamba2, RWKV6), encoder-decoder decode over stubbed audio frame
embeddings — and the continuous-batching engine (paged KV cache + slot
scheduler) on an attention arch, with draft-free speculative decode,
sampled decode on the reference's threefry-keyed streams and COW prefix
sharing (the reference's ``examples/serve_decode.py``).

  python -m repro_torch.examples.serve_decode                # on the card
  python -m repro_torch.examples.serve_decode --device cpu   # on the CPU
"""
import argparse
import time

import torch

from repro_torch import models
from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import encdec
from repro_torch.serve import (PageSpec, ServeEngine, repetitive_workload,
                               shared_prefix_workload, synthetic_workload)


def _init(cfg, dev):
    return models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    batch, plen, gen = 4, 16, 12
    out = {}

    for arch in ("gemma3-4b", "zamba2-2.7b", "rwkv6-7b"):
        cfg = reduced(get_config(arch))
        params = _init(cfg, dev)
        prompts = torch.randint(0, cfg.vocab_size, (batch, plen),
                                generator=torch.Generator().manual_seed(0))
        t0 = time.time()
        # attention archs prefill the whole prompt in one chunked call;
        # recurrent archs step token by token automatically
        toks = generate(cfg, params, prompts.to(dev), gen=gen,
                        max_seq=plen + gen).cpu()
        print(f"{arch:<22} {batch * gen / (time.time() - t0):6.1f} tok/s  "
              f"out shape {tuple(toks.shape)}")
        out[arch] = toks

    # continuous batching: requests arrive over time, join mid-flight as
    # pages free up, and leave individually — no static batch to drain
    cfg = reduced(get_config("gemma3-4b"))
    params = _init(cfg, dev)
    spec = PageSpec(page_len=16, pages_per_slot=4, n_slots=4)
    engine = ServeEngine(cfg, params, spec=spec, prefill_chunk=16, device=dev)
    reqs = synthetic_workload(0, 12, vocab=cfg.vocab_size,
                              prompt_lens=(4, 16), gen_short=(4, 8),
                              gen_long=(16, 24))
    t0 = time.time()
    recs = engine.serve(reqs)
    n_tok = sum(len(r.tokens) for r in recs)
    print(f"{'gemma3 (continuous)':<22} {n_tok / (time.time() - t0):6.1f} "
          f"tok/s  {len(recs)} reqs, mean TTFT "
          f"{1e3 * sum(r.ttft_s for r in recs) / len(recs):.0f}ms")

    # speculative decode: per-slot n-gram prompt lookup drafts up to k
    # tokens, one batched (m, k+1) verify step scores them, the longest
    # greedy-matching prefix is accepted — token-identical to one-token
    # decode, only the dispatch count changes
    reqs = repetitive_workload(0, 8, vocab=cfg.vocab_size, prompt_len=24,
                               gen=(24, 32))
    spc = ServeEngine(cfg, params, spec=spec, prefill_chunk=16, spec_k=3,
                      device=dev)
    t0 = time.time()
    recs = spc.serve(reqs)
    n_tok = sum(len(r.tokens) for r in recs)
    print(f"{'gemma3 (spec k=3)':<22} {n_tok / (time.time() - t0):6.1f} "
          f"tok/s  accept rate {spc.accept_rate:.2f} "
          f"({spc.stats['draft_accepted']}/{spc.stats['draft_proposed']} "
          f"drafts, {spc.stats['spec_dispatches']} verify dispatches)")

    # sampled decode: temperature / top-k selection inside the step, each
    # token keyed on (seed, request id, step), so that a replay is the same
    # whatever the batch composition; greedy-only speculation refuses it
    smp = ServeEngine(cfg, params, spec=spec, prefill_chunk=16,
                      temperature=0.8, top_k=40, sample_seed=7, device=dev)
    recs = smp.serve(reqs)
    out["gemma3-4b sampled"] = {r.rid: list(r.tokens) for r in recs}
    print(f"{'gemma3 (T=0.8 k=40)':<22} sampled {len(recs)} reqs, "
          f"first tokens {list(recs[0].tokens[:6])}")

    # COW prefix sharing: admission maps the full KV pages of a matching
    # earlier prompt into the new slot's table and skips their prefill; a
    # shared boundary page is duplicated before the first divergent write
    shr_reqs = shared_prefix_workload(0, 10, vocab=cfg.vocab_size,
                                      prefix_len=32, suffix_len=6, p_dup=0.4)
    shr = ServeEngine(cfg, params,
                      spec=PageSpec(page_len=8, pages_per_slot=10, n_slots=4),
                      prefill_chunk=16, prefix_share=True, device=dev)
    shr.serve(shr_reqs)
    print(f"{'gemma3 (prefix share)':<22} skipped "
          f"{shr.prefill_skip_frac:.0%} of prompt prefill "
          f"({shr.stats['prefill_skipped_tokens']}/"
          f"{shr.stats['prompt_tokens']} tokens, {shr.stats['cow_copies']} "
          "COW copies)")

    # enc-dec: the encoder output of stubbed frame embeddings, computed
    # once into the cache, then greedy one-token steps with the decoder's
    # self-attention cache and cross-attention over it, the position an
    # int32 tensor on the device advanced in place
    cfg = reduced(get_config("seamless-m4t-large-v2"))
    params = _init(cfg, dev)
    frames = torch.randn(2, cfg.encoder_seq, cfg.d_model,
                         generator=torch.Generator().manual_seed(0)).to(dev)
    cache = models.init_cache(cfg, 2, 24, device=dev)
    with torch.inference_mode():
        cache["enc_out"] = encdec.encode(params, cfg, frames)
    decode = make_decode_step(cfg)
    tok = torch.zeros((2, 1), dtype=torch.long, device=dev)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    t0 = time.time()
    steps = []
    for _ in range(24):
        logits, cache = decode(params, cache, tok, pos)
        pos.add_(1)
        tok = torch.argmax(logits, dim=-1)[:, None]
        steps.append(tok)
    out["seamless-m4t-large-v2"] = torch.cat(steps, dim=1).cpu()
    print(f"{'seamless (enc-dec)':<22} {2 * 24 / (time.time() - t0):6.1f} "
          f"tok/s  first tokens "
          f"{out['seamless-m4t-large-v2'][0, :8].tolist()}")
    return out


if __name__ == "__main__":
    main()
