"""Opt-in activation sharding constraints (the port of the reference's
``models/shard_ctx.py``), on DTensor, and the other placements the
port's mesh path makes explicitly.

The model code never names mesh axes; the launcher opts in with
``activation_sharding(...)`` and model code calls ``constrain(x, dims)``
with logical dim tags:

    "b"  batch         -> data axes
    "h"  heads/experts -> model axis (if the dim divides it)
    "m"  model dim     -> model axis (column-sharded activations)
    "."  unsharded

Inside the context a DTensor is redistributed to those placements (the
reference's ``with_sharding_constraint``); on a plain tensor, or outside
the context, ``constrain`` is a no-op, so single-device runs never see
the mesh.

The rest serve the mesh path whether or not the context is on, and each
is the identity on plain tensors: ``whole`` gathers dims where DTensor's
own strategy for the next op fails, ``on_rank_shards`` and ``lookup`` run
per-row work on each rank's shards and ``on_whole`` whole-tensor work on
every rank (``local_map``), and ``replicated_ops`` is the context a
sharded step runs in.  The layer-free helpers (``is_dtensor``,
``place_like``, ...) live in ``repro_torch.core.dtensor``.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch

from repro_torch.core.dtensor import axis_sizes, is_dtensor

_state = threading.local()


def _ctx():
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def activation_sharding(mesh, *, data_axes=("data",), model_axis="model"):
    sizes = axis_sizes(mesh)
    dsize = 1
    for a in data_axes:
        dsize *= sizes[a]
    prev = _ctx()
    _state.ctx = {"mesh": mesh, "data": tuple(data_axes),
                  "model": model_axis, "dsize": dsize,
                  "msize": sizes[model_axis]}
    try:
        yield
    finally:
        _state.ctx = prev


def constrain_first(x, options):
    """Apply the first dims string whose 'h' / 'm' tags all divide the
    model axis (e.g. MoE: shard experts if E % tp == 0, else the ff
    dim)."""
    ctx = _ctx()
    if ctx is None or not is_dtensor(x):
        return x
    for dims in options:
        if all(size % ctx["msize"] == 0
               for tag, size in zip(dims, x.shape) if tag in ("h", "m")):
            return constrain(x, dims)
    return x


def constrain(x, dims: str):
    """dims: one tag per tensor dim ('b', 'h', 'm', '.')."""
    ctx = _ctx()
    if ctx is None or not is_dtensor(x):
        return x
    if len(dims) != x.dim():
        raise ValueError(f"dims {dims!r} vs rank {x.dim()}")
    from torch.distributed.tensor import Replicate, Shard
    mesh = ctx["mesh"]
    sizes = axis_sizes(mesh)
    axis_dim = {}
    for d, (tag, size) in enumerate(zip(dims, x.shape)):
        if tag == "b" and size % ctx["dsize"] == 0:
            for a in ctx["data"]:
                axis_dim.setdefault(a, d)
        elif tag in ("h", "m") and size % ctx["msize"] == 0:
            axis_dim.setdefault(ctx["model"], d)
    # an axis of one rank holds the whole dim: replicate (DTensor refuses
    # some views of a dim sharded over one rank)
    axis_dim = {a: d for a, d in axis_dim.items() if sizes[a] > 1}
    return x.redistribute(mesh, [Shard(axis_dim[a]) if a in axis_dim
                                 else Replicate()
                                 for a in mesh.mesh_dim_names])


def whole(x, *dims):
    """``x`` with none of ``dims`` sharded and no pending sum: for a
    DTensor, each ``Shard(d)`` with ``d`` in ``dims`` becomes
    ``Replicate()`` (an all-gather over that mesh dim) and each
    ``Partial`` too (an all-reduce); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    nd = x.dim()
    dims = {d % nd for d in dims}
    pl = [p if isinstance(p, Replicate)
          or (isinstance(p, Shard) and p.dim not in dims) else Replicate()
          for p in x.placements]
    if list(pl) == list(x.placements):
        return x
    return _ContiguousGrad.apply(x.redistribute(x.device_mesh, pl))


def split_heads(x, shape):
    """``x.reshape(shape)`` where the last dim of ``x`` splits into
    ``shape[-2]`` heads of ``shape[-1]``.  On a DTensor whose last dim is
    sharded over a mesh dim that does not divide the heads, that dim is
    gathered first: DTensor cannot unflatten an uneven shard (granite's
    24 heads on a 16-wide model axis), where the reference's partitioner
    gathers or pads on its own."""
    if is_dtensor(x):
        last, n = x.dim() - 1, shape[-2]
        if any(p.is_shard(last) and n % x.device_mesh.size(i)
               for i, p in enumerate(x.placements)):
            x = whole(x, -1)
    return x.reshape(shape)


def merge_heads(x, shape):
    """``x.reshape(shape)`` where the last two dims of ``x`` (heads, head
    dim) merge into one.  On a DTensor whose head dim is sharded, it is
    gathered first: DTensor cannot flatten a sharded inner dim (rwkv6's
    64 heads of 64 on a 16-wide model axis, its heads whole and its head
    dim split)."""
    if is_dtensor(x):
        last = x.dim() - 1
        if any(p.is_shard(last) for p in x.placements):
            x = whole(x, -1)
    return x.reshape(shape)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous.  The
    backward of a gather cuts the whole gradient into shards, and the
    shards keep the whole gradient's strides as their global ones even
    where each local shard was copied contiguous: a later view that the
    global strides allow then fails on the shard (the MoE combine's
    gradient, laid out (N, C, E, D) by its einsum, cut along E)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def on_rank_shards(fn, args, dims, out_dims):
    """``fn(*args)`` on each rank's shards, for math independent per
    (batch row, head) — attention, the scans (``local_map``): ``dims``
    holds one tag string per arg (``"b"`` batch, ``"h"`` heads, ``"."``
    any other dim; ``None`` for an arg passed as it is) and ``out_dims``
    the output's (a tuple of them for several outputs).  The data axes
    shard the ``"b"`` dims where every such dim divides their ranks, the
    model axis the ``"h"`` dims where every one divides its ranks, and
    the rest is whole (an arg whole on such an axis takes the sum of the
    ranks' gradients): for attention exactly
    the partition of the reference's ``"bh.."`` constraint.  DTensor
    propagates nothing inside (it cannot flatten a sharded head dim into
    the batch of a product in every PyTorch release), each kernel call
    sees local shapes, and a cost count its work on one rank.  Without a
    DTensor arg, ``fn(*args)``."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    sizes = axis_sizes(mesh)
    data = [a for a in mesh.mesh_dim_names if a in ("pod", "data")]
    dsize = 1
    for a in data:
        dsize *= sizes[a]
    tagged = [(a, d) for a, d in zip(args, dims) if d is not None]
    ok = {tag: any(tag in d for _, d in tagged)
          and all(a.shape[d.index(tag)] % n == 0
                  for a, d in tagged if tag in d)
          for tag, n in (("b", dsize), ("h", sizes.get("model", 1)))}

    def pl(d, grad=False):
        out = []
        for a in mesh.mesh_dim_names:
            tag = "b" if a in data else "h" if a == "model" else None
            split = tag is not None and sizes[a] > 1 and ok[tag]
            if split and tag in d:
                out.append(Shard(d.index(tag)))
            elif split and grad:
                # whole on ranks that each use their own rows or heads
                # with it (a scan's decay, say): its gradient is their sum
                out.append(Partial())
            else:
                out.append(Replicate())
        return out
    outs = tuple(pl(d) for d in out_dims) if isinstance(out_dims, tuple) \
        else pl(out_dims)
    return local_map(fn, out_placements=outs,
                     in_placements=tuple(None if d is None else pl(d)
                                         for d in dims),
                     in_grad_placements=tuple(
                         None if d is None else pl(d, grad=True)
                         for d in dims),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def write_rows(dst, dim: int, index, src) -> None:
    """``dst.index_copy_(dim, index, src)`` in place, where ``dst`` may be
    a DTensor, sharded along ``dim`` or not (a long-context cache whose
    positions the data axes shard).  Some releases have no DTensor
    strategy for ``index_copy_``, and others label a result sharded along
    ``dim`` with a wrong placement, so each rank writes its own shard:
    ``src`` placed as ``dst`` is except whole along ``dim``, each index
    moved by the shard's offset, and rows outside the shard left as they
    were (a masked write: the indices may live on the device).  Shards are
    even (``launch.sharding.cache_specs`` shards only dims their axes
    divide)."""
    if not is_dtensor(dst):
        dst.index_copy_(dim, index, src)
        return
    from torch.distributed.tensor import Replicate
    mesh = dst.device_mesh
    pl = [Replicate() if p.is_shard(dim) else p for p in dst.placements]
    src = src.redistribute(mesh, pl).to_local() if is_dtensor(src) \
        else src
    index = index.to_local() if is_dtensor(index) else index
    local = dst.to_local()
    n = local.shape[dim]
    coord, shard = mesh.get_coordinate(), 0
    for i, p in enumerate(dst.placements):
        if p.is_shard(dim):
            shard = shard * mesh.size(i) + coord[i]
    at = index - shard * n
    inside = (at >= 0) & (at < n)
    at = at.clamp(0, n - 1)
    shape = [1] * local.dim()
    shape[dim] = -1
    keep = local.index_select(dim, at)
    local.index_copy_(dim, at, torch.where(inside.reshape(shape), src, keep))


def on_whole(fn, args, n_out: int):
    """``fn(*args)`` with every DTensor arg whole on each rank and its
    ``n_out`` tensor outputs replicated DTensors (``local_map``): neither
    the forward nor the backward asks DTensor to propagate through
    ``fn``, whose views some releases refuse on sharded dims (the MoE
    capacity queues).  Without a DTensor arg, ``fn(*args)``."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    rep = [Replicate()] * mesh.ndim
    pl = tuple(rep if is_dtensor(a) else None for a in args)
    return local_map(fn, out_placements=(rep,) * n_out, in_placements=pl,
                     in_grad_placements=pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def lookup(table, idx):
    """``table[idx]``: embedding rows.  For a DTensor table each rank looks
    up its own rows of ``idx`` (batch-sharded, or whole) in the whole
    table (``local_map``); the table's gradient is a sum over the data
    ranks' rows (``Partial``), which the step places as the table is.
    DTensor's own index / ``index_put`` strategies fail on such shards in
    some PyTorch releases.  A plain table is indexed as it is."""
    if not is_dtensor(table):
        return table[idx]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    idx_pl = list(idx.placements) if isinstance(idx, DTensor) \
        else [Replicate()] * mesh.ndim
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in idx_pl]
    whole_table = [Replicate()] * mesh.ndim
    grad = [Partial() if p.is_shard() else Replicate() for p in rows]
    return local_map(lambda t, i: t[i], out_placements=rows,
                     in_placements=(whole_table, rows),
                     in_grad_placements=(grad, rows), device_mesh=mesh,
                     redistribute_inputs=True)(table, idx)


@functools.cache
def _register_strategies():
    """DTensor strategies this port's steps need that some PyTorch
    releases lack: ``roll`` (RoPE's rotate-half) keeps any shard off the
    rolled dims, and so does ``flip`` (in ``cumsum``'s backward, which the
    Mamba2 scan's training form runs)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.roll.default)
    def _roll(x, shifts, dims=()):
        nd = len(x.shape)
        dims = dims if isinstance(dims, (list, tuple)) else (dims,)
        rolled = {d % nd for d in dims} if dims else set(range(nd))
        return [([Replicate()], [Replicate(), None, None])] + [
            ([Shard(d)], [Shard(d), None, None])
            for d in range(nd) if d not in rolled]

    @register_sharding(torch.ops.aten.flip.default)
    def _flip(x, dims):
        nd = len(x.shape)
        flipped = {d % nd for d in dims}
        return [([Replicate()], [Replicate(), None])] + [
            ([Shard(d)], [Shard(d), None])
            for d in range(nd) if d not in flipped]


def replicated_ops():
    """The context in which sharded steps run: plain tensors made inside
    the model (positions, masks, zeros) join DTensor ops as replicated
    DTensors (and the strategies of ``_register_strategies`` are in
    place)."""
    from torch.distributed.tensor.experimental import implicit_replication
    _register_strategies()
    return implicit_replication()
