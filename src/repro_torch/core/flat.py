"""Flat parameter store: the tree ⇄ flat-buffer codec behind the fused
server-update hot path.

The paper's §3.4 server update is elementwise over the *whole* parameter
vector, but parameters live in a tree — and updating leaf by leaf means
one kernel launch per leaf, every step.  The codec computes the layout
ONCE per tree structure — leaf offsets, shapes, dtypes and the padded
``(rows, LANE)`` buffer shape — so the hot loop carries a single buffer:

  * ``FlatSpec.ravel``    tree -> padded (rows, LANE) store-dtype buffer
  * ``FlatSpec.unravel``  buffer -> tree of VIEWS into the buffer
  * ``flat_spec(tree)``   cached on (treedef, leaf shapes, leaf dtypes,
    store dtype), so every phase reuses one spec

The geometry is the reference's exactly (``LANE``/``SUBLANE`` row padding,
block-aligned rows above ``MAX_WHOLE_ROWS``) and the leaf order is
``jax.tree_util``'s (``core.tree``), so a buffer raveled here is
byte-equal to the JAX package's for the same parameters.  The TPU tiling
that motivated the geometry does not bind the CUDA kernels; it stays so
buffers and checkpoints compare byte for byte.

``unravel`` returns views (``torch.split`` of the flat buffer) for the
leaves of the store's dtype and cast copies for the others; the fused
step takes the gradient w.r.t. those leaves and ravels it into one
``(rows, LANE)`` buffer — the flat, already-merged gradient, as in the
reference's ``engine/steps.py``.

Precision: ``store_dtype`` (default float32) sets the buffer dtype.  A
bfloat16 store halves the buffer's bytes and pads rows to 16;
``ravel_master`` then produces the float32 MASTER buffer with the SAME
geometry, which the mixed-dtype kernels update alongside the bf16 shadow.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.device import resolve_device

LANE = 128            # last dim of the flat buffer
SUBLANE = 8           # f32 row padding granularity
SUBLANE_BF16 = 16     # 2-byte dtypes pad rows to 16
MAX_WHOLE_ROWS = 2048  # the reference's whole-buffer kernel limit
BLOCK_ROWS = 1024     # rows pad to this multiple above MAX_WHOLE_ROWS


def _sublane(store_dtype) -> int:
    return SUBLANE_BF16 if store_dtype.itemsize == 2 else SUBLANE


def sublane_for(store_dtype) -> int:
    """Public form of the sublane-tile rule: the row-padding granularity a
    ``(rows, LANE)`` buffer of ``store_dtype`` respects (8 rows for f32,
    16 for 2-byte dtypes).  The KV page pool (``serve.paged``) sizes its
    pages off the same rule, as the reference does."""
    return _sublane(store_dtype)


def padded_len(n: int, store_dtype=torch.float32) -> int:
    """``n`` rounded up to the sublane tile of ``store_dtype`` (the 1D
    analogue of ``padded_rows``)."""
    sub = _sublane(store_dtype)
    return -(-max(int(n), 1) // sub) * sub


def padded_rows(n: int, store_dtype=torch.float32) -> int:
    """Rows of the (rows, LANE) buffer holding ``n`` elements: lane- and
    sublane-aligned (8 rows for f32, 16 for 2-byte dtypes), and
    ``BLOCK_ROWS``-aligned once above ``MAX_WHOLE_ROWS`` — the reference's
    geometry, kept so buffers stay byte-identical."""
    sub = _sublane(store_dtype)
    rows = max(1, -(-n // LANE))
    rows = -(-rows // sub) * sub
    if rows > MAX_WHOLE_ROWS:
        rows = -(-rows // BLOCK_ROWS) * BLOCK_ROWS
    return rows


class FlatSpec:
    """One tree structure's flat layout (offsets/shapes computed once)."""

    def __init__(self, treedef, shapes: Tuple[tuple, ...],
                 dtypes: Tuple[torch.dtype, ...],
                 store_dtype: torch.dtype = torch.float32):
        self.treedef = treedef
        self.shapes = tuple(tuple(s) for s in shapes)
        self.dtypes = tuple(dtypes)
        self.store_dtype = store_dtype
        self.sizes = tuple(_numel(s) for s in self.shapes)
        offs, off = [], 0
        for sz in self.sizes:
            offs.append(off)
            off += sz
        self.offsets = tuple(offs)
        self.n = off                       # live elements
        self.rows = padded_rows(self.n, self.store_dtype)
        self.shape = (self.rows, LANE)     # the buffer shape
        self.pad = self.rows * LANE - self.n

    def __repr__(self):
        return (f"FlatSpec(n={self.n}, rows={self.rows}, "
                f"leaves={len(self.sizes)}, store={self.store_dtype})")

    @property
    def store_bytes(self) -> int:
        """Bytes of one store buffer (padding included)."""
        return self.rows * LANE * self.store_dtype.itemsize

    # -- codec ---------------------------------------------------------
    def _ravel_as(self, tree, dtype, out=None):
        leaves, _ = tree_flatten(tree)
        if len(leaves) != len(self.sizes):
            raise ValueError(f"tree has {len(leaves)} leaves, spec expects "
                             f"{len(self.sizes)}")
        if out is None:
            out = torch.empty(self.shape, dtype=dtype,
                              device=leaves[0].device)
        elif tuple(out.shape) != self.shape or out.dtype != dtype:
            raise ValueError(f"out is {out.dtype} {tuple(out.shape)}, the "
                             f"spec needs {dtype} {self.shape}")
        # each leaf cast straight into its place: no per-leaf copies and
        # no concatenation beside the buffer (at a 3.8 G-element store
        # those are two more buffers' worth of memory)
        flat = out.view(-1)
        for leaf, off, size in zip(leaves, self.offsets, self.sizes):
            flat[off:off + size].copy_(leaf.detach().reshape(-1))
        flat[self.n:].zero_()
        return out

    def ravel(self, tree) -> torch.Tensor:
        """tree -> new (rows, LANE) ``store_dtype`` buffer on the leaves'
        device.  Works for any tree of this structure (params, velocity,
        gradients) regardless of leaf dtype."""
        return self._ravel_as(tree, self.store_dtype)

    def ravel_master(self, tree, out=None) -> torch.Tensor:
        """tree -> (rows, LANE) float32 MASTER buffer with this spec's
        exact geometry (``ravel`` itself on an f32 spec), written into
        ``out`` when given."""
        return self._ravel_as(tree, torch.float32, out)

    def unravel(self, buf: torch.Tensor):
        """(rows, LANE) buffer -> tree with the original shapes.  Leaves
        whose dtype is the buffer's are VIEWS into it (writes to the
        buffer show through, and autograd gathers their gradients into one
        flat buffer); others are cast copies."""
        if tuple(buf.shape) != self.shape:
            raise ValueError(f"buffer shape {tuple(buf.shape)} != spec "
                             f"shape {self.shape}")
        pieces = buf.reshape(-1).split(self.sizes + (self.pad,))
        leaves = []
        for piece, shape, dt in zip(pieces, self.shapes, self.dtypes):
            leaf = piece.view(shape)
            leaves.append(leaf if leaf.dtype == dt else leaf.to(dt))
        return tree_unflatten(self.treedef, leaves)

    # -- stacked per-worker buffers (trace-compiled PS simulator) ------
    def zeros_stacked(self, n: int, device=None) -> torch.Tensor:
        """Zero ``(n, rows, LANE)`` f32 stack — one flat row block per
        simulated worker (fresh workers, zero velocity); ``device=None``
        means the card."""
        return torch.zeros((int(n),) + self.shape, dtype=torch.float32,
                           device=resolve_device(device))

    def zeros_candidates(self, n_candidates: int, n_workers: int,
                         device=None) -> torch.Tensor:
        """Zero ``(n_candidates, n_workers, rows, LANE)`` f32 buffer — the
        batched candidate replay's velocity state: one stacked per-worker
        block per autotuner candidate, so one batched B3 launch updates
        every candidate's simulated cluster; ``device=None`` means the
        card."""
        return torch.zeros((int(n_candidates), int(n_workers)) + self.shape,
                           dtype=torch.float32,
                           device=resolve_device(device))

    def ravel_stacked(self, trees) -> torch.Tensor:
        """Per-worker trees -> ``(len(trees), rows, LANE)`` stack."""
        return torch.stack([self.ravel(t) for t in trees])

    def unravel_stacked(self, buf: torch.Tensor):
        """``(n, rows, LANE)`` stack -> list of n trees (views)."""
        return [self.unravel(buf[i]) for i in range(buf.shape[0])]


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


_SPECS: Dict[tuple, FlatSpec] = {}


def flat_spec(tree, store_dtype: Optional[torch.dtype] = None) -> FlatSpec:
    """The (cached) ``FlatSpec`` for ``tree``'s structure.  Two trees with
    equal treedef + leaf shapes/dtypes (and store dtype — ``None`` means
    f32) share one spec object."""
    leaves, treedef = tree_flatten(tree)
    shapes = tuple(tuple(l.shape) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    store = store_dtype if store_dtype is not None else torch.float32
    key = (treedef, shapes, dtypes, store)
    spec = _SPECS.get(key)
    if spec is None:
        spec = FlatSpec(treedef, shapes, dtypes, store)
        _SPECS[key] = spec
    return spec


@dataclass
class FlatParams:
    """Parameters living in the flat store: one buffer + its codec.

    ``master`` (bf16 stores) is the float32 master buffer in the same
    geometry; when present it is the value of record — ``to_tree`` reads
    it.
    """
    buf: Any
    spec: FlatSpec
    master: Optional[Any] = None

    @classmethod
    def from_tree(cls, tree, spec: FlatSpec | None = None) -> "FlatParams":
        spec = spec or flat_spec(tree)
        master = (spec.ravel_master(tree)
                  if spec.store_dtype != torch.float32 else None)
        return cls(spec.ravel(tree), spec, master)

    def to_tree(self):
        src = self.buf if self.master is None else self.master
        return self.spec.unravel(src)
