"""Serving stack: paged KV cache + continuous-batching slot scheduler.

  ``repro_torch.serve.paged``      the block-paged KV pool (flat-store
                                   tiling rules generalized to KV pages)
                                   and the batched paged / contiguous step
                                   functions that share one attention math
                                   path — decode (m, 1), chunked prefill
                                   (1, C) and the speculative verify chunk
                                   (m, k+1) — with the hand-written paged
                                   decode kernel on the card's decode
                                   ticks; plus token selection and the COW
                                   page copy
  ``repro_torch.serve.draft``      draft-model-free n-gram prompt lookup +
                                   greedy acceptance (host bookkeeping)
  ``repro_torch.serve.scheduler``  host-side hook-driven serve loop:
                                   admission with page-budget accounting
                                   and prefix sharing (refcounted pages,
                                   COW on boundary writes), slot
                                   assignment, chunked prefill interleaved
                                   with decode, eviction returning pages
  ``repro_torch.serve.engine``     ``ServeEngine`` — the device half behind
                                   the scheduler hooks: in-place cache
                                   updates, speculative draft→verify→accept
                                   decode, one-sync-per-tick token
                                   selection, per-request latency records
"""
from repro_torch.serve.draft import accepted_prefix_len, propose_ngram
from repro_torch.serve.engine import ServeEngine, ServeRecord
from repro_torch.serve.paged import PageSpec
from repro_torch.serve.scheduler import (PagePool, PrefixRegistry, Request,
                                         repetitive_workload, run_serve_loop,
                                         shared_prefix_workload,
                                         synthetic_workload)

__all__ = ["ServeEngine", "ServeRecord", "PageSpec", "PagePool",
           "PrefixRegistry", "Request", "run_serve_loop",
           "synthetic_workload", "repetitive_workload",
           "shared_prefix_workload", "propose_ngram",
           "accepted_prefix_len"]
