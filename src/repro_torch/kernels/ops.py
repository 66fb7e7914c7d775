"""Public front ends of the port's kernels (the reference's
``kernels/ops.py``), with the reference's signatures and layouts.

``backend`` is ``"auto"`` (the kernel for CUDA tensors, the plain version
for CPU tensors), ``"cuda"`` (the kernel; refused for CPU tensors) or
``"plain"`` (the plain version; refused for CUDA tensors), as
``flash_decode.resolve_impl`` rules.  The reference's ``"pallas"`` is
``"cuda"`` here; its ``interpret`` has no counterpart.  Every branch runs
in the kernel's layout: on the CPU the wrappers transpose around the
per-step oracles themselves (ROADMAP C7: the reference's CPU branch of
``mamba_ssd`` and ``wkv6`` hands the ``(B, H, S, ·)`` tensors to oracles
that take ``(B, S, H, ·)``, which the port does not copy).

``backend`` and ``chunk`` exist for the reference's signatures only: the
tensor's device picks the branch (``backend`` can only confirm it or
raise), and ``chunk`` changes nothing: B7 runs chunks of 64 steps in bf16
and the recurrence step by step in f32, B8 loops over the whole sequence
in one block.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import mamba_scan as _ssd
from repro_torch.kernels import wkv6 as _wkv
from repro_torch.kernels.dbl_merge import dbl_merge_tree


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    backend: str = "auto"):
    """q: (B,H,Sq,hd); k,v: (B,KV,Sk,hd) -> (B,H,Sq,hd)."""
    _fd.resolve_impl(backend, q.device)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def flash_decode(q, k_cache, v_cache, pos, *, window: int = 0,
                 backend: str = "auto"):
    """Single-token decode attention. q: (B,H,1,hd); caches (B,KV,S,hd);
    ``pos`` a host int or a 0-d int32 tensor on q's device."""
    _fd.resolve_impl(backend, q.device)
    return _fd.flash_decode(q, k_cache, v_cache, pos, window=window)


def mamba_ssd(x, dt, A_log, B, C, D_skip, *, chunk: int = 128,
              backend: str = "auto"):
    """x: (Bt,H,S,P); dt: (Bt,H,S); B,C: (Bt,S,N) -> y (Bt,H,S,P)."""
    _fd.resolve_impl(backend, x.device)
    return _ssd.mamba_ssd_scan(x, dt, A_log, B, C, D_skip, chunk=chunk)


def wkv6(r, k, v, w, u, *, chunk: int = 128, backend: str = "auto"):
    """r,k,w: (B,H,S,K); v: (B,H,S,V); u: (H,K) -> y (B,H,S,V)."""
    _fd.resolve_impl(backend, r.device)
    return _wkv.wkv6_chunked(r, k, v, w, u, chunk=chunk)


def dbl_merge(params, g_large, g_small, *, factor: float, lr: float,
              backend: str = "auto", leafwise: bool | None = None):
    """Fused dual-batch server update over parameter trees.

    Trees of plain tensors take the flat-store single-launch path
    (``dbl_merge_tree``); DTensor trees take one B2 launch per leaf on its
    local shard, in place (``leafwise=True``; ``None`` picks it for any
    DTensor tree).  The reference picks it for a sharded tree only; a
    replicated or one-rank DTensor tree cannot ravel into one store
    either, and B2 gives the same bits leaf by leaf."""
    from repro_torch.core.dtensor import is_dtensor
    from repro_torch.core.tree import tree_leaves
    if leafwise is None:
        leafwise = any(is_dtensor(p) for p in tree_leaves(params))
    _fd.resolve_impl(backend, tree_leaves(params)[0].device)
    return dbl_merge_tree(params, g_large, g_small, factor=factor, lr=lr,
                          leafwise=leafwise)
