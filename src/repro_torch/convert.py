"""Carry weights and flat buffers across from the JAX package.

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
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


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
