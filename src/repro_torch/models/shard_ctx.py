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
own strategy for the next op fails, ``on_shards`` and ``lookup`` run
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


def on_shards(fn, args):
    """``fn(*args)`` on each rank's shards of the ``(B, S, H, hd)``
    DTensors ``args``, each batch row and head where it lies
    (``local_map``): the batch dim over the data axes and the head dim
    over the model axis where every arg's dim divides, else whole.  For math that is independent per (batch
    row, head) — attention — this is exactly the partition of the
    reference's ``"bh.."`` constraint, and DTensor propagates nothing
    inside (it cannot flatten a sharded head dim into the batch of a
    product in every PyTorch release).  Returns one DTensor on the
    args' placements."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = args[0].device_mesh
    sizes = axis_sizes(mesh)
    data = [a for a in mesh.mesh_dim_names if a in ("pod", "data")]
    dsize = 1
    for a in data:
        dsize *= sizes[a]
    shard_b = all(t.shape[0] % dsize == 0 for t in args)
    pl = []
    for a in mesh.mesh_dim_names:
        if sizes[a] > 1 and a in data and shard_b:
            pl.append(Shard(0))
        elif sizes[a] > 1 and a == "model" and all(
                t.shape[2] % sizes[a] == 0 for t in args):
            pl.append(Shard(2))
        else:
            pl.append(Replicate())
    # one output: its placements as a list (a tuple means one per output)
    return local_map(fn, out_placements=pl, in_placements=(pl,) * len(args),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


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
    rolled dims."""
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


def replicated_ops():
    """The context in which sharded steps run: plain tensors made inside
    the model (positions, masks, zeros) join DTensor ops as replicated
    DTensors (and the strategies of ``_register_strategies`` are in
    place)."""
    from torch.distributed.tensor.experimental import implicit_replication
    _register_strategies()
    return implicit_replication()
