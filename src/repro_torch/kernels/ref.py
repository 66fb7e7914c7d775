"""Plain-PyTorch oracles for the dual-batch merge (the reference's
``kernels/ref.py``, dbl parts)."""
from __future__ import annotations

from repro_torch.core.tree import tree_map


def dbl_merge_ref(p, g_large, g_small, *, factor, lr):
    """Paper §3.4 server update, fused-form oracle:
    w' = w − lr·(g_L + f·g_S)/(1 + f)."""
    gl = g_large.float()
    gs = g_small.float()
    step = (gl + factor * gs) / (1.0 + factor)
    return (p.float() - lr * step).to(p.dtype)


def dbl_merge_unfused(p, g_large, g_small, *, factor, lr):
    """The naive scale/add/normalize/apply sequence over trees, each
    intermediate materialized (eager PyTorch materializes every op) — the
    parameter-sized round trips the fused kernel removes."""
    merged = tree_map(lambda gl, gs: gl.float() + factor * gs.float(),
                      g_large, g_small)
    step = tree_map(lambda m: m * (1.0 / (1.0 + factor)), merged)
    return tree_map(lambda w, s: (w.float() - lr * s).to(w.dtype), p, step)
