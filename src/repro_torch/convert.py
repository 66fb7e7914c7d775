"""Carry weights, optimizer state and flat buffers across from the JAX
package.

The caller hands numpy arrays (for a JAX tree,
``jax.tree_util.tree_map(np.asarray, params)``); nothing here imports
jax.  bfloat16 arrays (numpy's ``ml_dtypes`` extension type) cross as
their raw 16-bit patterns, so a bf16 flat store arrives bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device


def tensor_from_numpy(arr, device=None) -> torch.Tensor:
    """numpy array (f32, int, or bf16) -> tensor on ``device`` (``None``
    means the card), bits unchanged."""
    device = resolve_device(device)
    arr = np.asarray(arr)
    if not arr.flags.writeable:           # e.g. a view of a JAX buffer
        arr = arr.copy()
    # np.asarray(order="C"), not np.ascontiguousarray, which makes a 0-d
    # array 1-d
    arr = np.asarray(arr, order="C")
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy on the host; bf16 comes back as its ``uint16`` bit
    pattern (numpy has no bf16 of its own)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def params_from_numpy(tree, device=None):
    """A tree (dicts/lists) of numpy arrays in the reference's structure ->
    the same tree of tensors on ``device`` (``None`` means the card)."""
    device = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def params_to_numpy(tree):
    """A tree of tensors -> the same tree of numpy arrays with exact
    dtypes, for the JAX package: bf16 leaves come back as ``ml_dtypes``'
    bfloat16 (the type JAX hands numpy), bit for bit."""
    def one(t):
        a = tensor_to_numpy(t)
        if t.dtype == torch.bfloat16:
            import ml_dtypes              # present wherever JAX is
            a = a.view(ml_dtypes.bfloat16)
        return a
    return tree_map(one, tree)


def lm_params_from_numpy(tree, cfg, device=None):
    """The JAX package's LM parameters (``init_params`` of
    ``repro.models.transformer``, as a numpy tree) -> the port's tree on
    ``device`` (``None`` means the card).  The two trees share key paths
    and the stacked ``(count, ...)`` segment layout — attention, Mamba2
    and RWKV-6 segments alike, and the empty ``{}`` of each call of a
    weight-tied shared block, whose parameters sit under ``"shared"`` —
    so the mapping is leaf for leaf; this checks that the segments stack
    ``layout(cfg)``."""
    from repro_torch.configs.base import SHARED_ATTN
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.transformer import layout
    segs = layout(cfg)
    if len(tree["segments"]) != len(segs):
        raise ValueError(f"{len(tree['segments'])} segments for {cfg.name}, "
                         f"whose layout has {len(segs)}")
    if bool(cfg.shared_every) != ("shared" in tree):
        raise ValueError(f"{cfg.name}: shared_every {cfg.shared_every} but "
                         f"the tree {'has' if 'shared' in tree else 'lacks'} "
                         "a 'shared' block")
    for seg, sp in zip(segs, tree["segments"]):
        if seg.kind == SHARED_ATTN and sp:
            raise ValueError(f"a shared_attn segment holds {sorted(sp)}: its "
                             "parameters belong under 'shared'")
        for leaf in tree_leaves(sp):
            if np.shape(leaf)[0] != seg.count:
                raise ValueError(f"a {seg.kind} segment of {seg.count} "
                                 f"layers holds a leaf of shape "
                                 f"{np.shape(leaf)}")
    return params_from_numpy(tree, device)


def opt_state_from_numpy(state, device=None):
    """The JAX package's optimizer state as a numpy tree -> the port's on
    ``device`` (``None`` means the card): AdamW's ``{"m", "v", "t"}`` (the
    step count a 0-d int32, as both packages keep it) or SGD's
    ``{"v"}``, each moment tree in its params' structure."""
    keys = set(state)
    if keys not in ({"m", "v", "t"}, {"v"}):
        raise ValueError(f"not an AdamW or SGD state: keys {sorted(keys)}")
    if "t" in state:
        t = np.asarray(state["t"])
        if t.shape != () or t.dtype != np.int32:
            raise ValueError(f"AdamW's step count must be a 0-d int32, got "
                             f"{t.dtype} of shape {t.shape}")
    return params_from_numpy(state, device)
