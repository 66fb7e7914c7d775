"""Tree checkpointing on npz, in the reference's file format
(``checkpoint/ckpt.py`` of the JAX package).

Leaves are flattened to ``path/to/leaf`` npz entries under the key paths
``jax.tree_util.tree_flatten_with_path`` gives the same tree: dict keys
sorted (the key itself), ``[i]`` for list and tuple items, the field
name for namedtuple fields, and no leaf for ``None``.  Leaves are written
in that order, bf16 ones upcast to f32 (numpy has no bf16), and numpy
leaves at their own dtype, so a tree written here is byte-identical to
the same tree written by the reference (the zip entries carry the time of
writing, as ``np.savez`` stamps them), and each package loads the
other's files.  Structure (lists vs dicts, namedtuples, leaf dtypes) is
taken on load from a reference tree of the same structure.

Flat-store aware: ``repro_torch.core.flat.FlatParams`` nodes anywhere in
the tree are expanded through their codec before saving and re-packed on
load, so a file written from a flat store equals one written from the
plain tree.  A bf16 store's ``to_tree`` reads its f32 master (the value
of record), and restoring into a bf16 ``FlatParams`` rebuilds the master
and the re-rounded bf16 shadow from the file's f32 values.
"""
from __future__ import annotations

import os
import re
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.flat import FlatParams


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _map_with_path(fn: Callable, tree, path=()):
    """``fn(path, leaf)`` over the leaves of ``tree`` in the reference's
    flatten order, rebuilding the containers (``FlatParams`` nodes are
    leaves here)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f),
                                           path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        items = [_map_with_path(fn, c, path + (f"[{i}]",))
                 for i, c in enumerate(tree)]
        return items if isinstance(tree, list) else tuple(items)
    return fn(path, tree)


def _expand_flat(tree):
    """Replace every FlatParams node by its public tree."""
    return _map_with_path(
        lambda _, l: l.to_tree() if isinstance(l, FlatParams) else l, tree)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            # numpy can't hold bf16: store f32 (a lossless upcast; the
            # load casts back to the reference leaf's dtype)
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    flat = {}

    def put(path, leaf):
        flat["/".join(path)] = _to_numpy(leaf)
    _map_with_path(put, tree)
    return flat


def save_checkpoint(path: str, step: int, tree: Any) -> str:
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    tmp = fname + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **_flatten(_expand_flat(tree)))
    os.replace(tmp, fname)
    return fname


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for f in os.listdir(path)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def restore_latest(path: str, like: Any) -> tuple:
    """(step, tree) from the newest checkpoint under ``path``, or
    (None, None) when there is none — the backends' phase-boundary resume
    entry point."""
    step = latest_step(path)
    if step is None:
        return None, None
    return step, load_checkpoint(path, step, like)


def _restore_leaf(arr: np.ndarray, ref):
    """A file array as ``ref``'s kind: a tensor of its dtype on its device,
    or a numpy array of its exact dtype (a backend's float64 clock keeps
    every bit)."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.asarray(arr, order="C")).to(
            device=ref.device, dtype=ref.dtype)
    return arr.astype(np.asarray(ref).dtype)


def load_checkpoint(path: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like`` (shapes validated, dtypes
    and devices taken from it).  ``FlatParams`` nodes restore through
    their codec (the file holds the public tree's keys)."""
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    with np.load(fname) as data:
        def load(path_keys, ref):
            key = "/".join(path_keys)
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(np.shape(ref)):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(np.shape(ref))}")
            return _restore_leaf(arr, ref)

        def node(path_keys, ref):
            if not isinstance(ref, FlatParams):
                return load(path_keys, ref)
            # the codec's public tree: leaf shapes and dtypes from the spec
            spec = ref.spec
            src = ref.buf if ref.master is None else ref.master
            tree = _map_with_path(load, spec.unravel(src), path_keys)
            return FlatParams.from_tree(tree, spec=spec)
        return _map_with_path(node, like)
