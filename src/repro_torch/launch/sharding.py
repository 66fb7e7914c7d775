"""Divisibility-aware sharding rules (the port of the reference's
``launch/sharding.py``), and their DTensor placements.

Parameters shard 2-D: column-parallel projections ``(fsdp, tp)``,
row-parallel ``(tp, fsdp)`` — FSDP on ``"data"``, tensor-parallel on
``"model"``, replicated over ``"pod"``.  Stacked layer dims (the leading
per-layer axis of a segment) stay unsharded.  Any dim not divisible by
its mesh axis falls back to ``None`` (e.g. gemma3's 8 heads on a 16-wide
model axis: the attention projections shard on the fused ``H*hd`` column
instead).

A spec is a tuple with one entry per dim: an axis name, a tuple of names
(the batch dim over ``("pod", "data")``) or ``None`` — the reference's
``PartitionSpec`` entries, a one-name tuple written as the name, as
``PartitionSpec`` itself compares them.  The rules read only path names,
shapes and the mesh's named axis sizes, so they take a ``DeviceMesh`` or
any stand-in with ``shape`` (a dict of axis sizes) and ``axis_names``.
``placements`` turns a spec into DTensor placements on a ``DeviceMesh``
and ``distribute_tree`` places a whole tree.
"""
from __future__ import annotations

from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.core.dtensor import axis_sizes
from repro_torch.launch.mesh import data_axes

FSDP_AXIS = "data"
TP_AXIS = "model"

# classification by trailing param-path name
_COL_PARALLEL = {"wq", "wk", "wv", "wi", "wg", "w_in", "w_r", "w_k", "w_v",
                 "w_g", "cw_k", "cw_r", "res_wi", "res_wg", "w_lora_a"}
_ROW_PARALLEL = {"wo", "w_out", "cw_v", "res_wo", "w_lora_b"}
_VOCAB_MAJOR = {"embed", "lm_head"}
_REPLICATED = {"router"}       # (D, E): small; replicate for exact routing


def _fit(dim: int, sizes: dict, axis: str):
    """``axis`` if it divides ``dim``, else None."""
    return axis if dim % sizes[axis] == 0 else None


def _spec(*entries) -> tuple:
    """The spec tuple, a one-name tuple written as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def spec_for(path_names, shape, mesh) -> tuple:
    """The spec of one param leaf; ``path_names``: its tuple of keys (a
    list index under ``"segments"`` named ``"segments"``)."""
    sizes = axis_sizes(mesh)
    name = path_names[-1] if path_names else ""
    nd = len(shape)
    # a segment's per-layer params stack on a leading layer axis, which
    # stays unsharded
    stacked = int(nd >= 2 and any(p in ("segments", "enc", "dec")
                                  for p in path_names))
    core = tuple(shape[stacked:])
    lead = (None,) * stacked

    if len(core) <= 1 or name in _REPLICATED:
        return _spec(*lead, *([None] * len(core)))

    if name in _VOCAB_MAJOR:
        return _spec(_fit(core[0], sizes, TP_AXIS),
                     _fit(core[1], sizes, FSDP_AXIS))

    if name in ("wi", "wg", "wo") and len(core) == 3:
        # MoE expert weights (E, D, F) / (E, F, D): expert-parallel on model
        e = _fit(core[0], sizes, TP_AXIS)
        if e is not None:
            return _spec(*lead, e, _fit(core[1], sizes, FSDP_AXIS), None)
        # experts don't divide (granite's 40): shard the ff dim instead
        if name in ("wi", "wg"):
            return _spec(*lead, None, _fit(core[1], sizes, FSDP_AXIS),
                         _fit(core[2], sizes, TP_AXIS))
        return _spec(*lead, None, _fit(core[1], sizes, TP_AXIS),
                     _fit(core[2], sizes, FSDP_AXIS))

    if name in _COL_PARALLEL and len(core) == 2:
        return _spec(*lead, _fit(core[0], sizes, FSDP_AXIS),
                     _fit(core[1], sizes, TP_AXIS))
    if name in _ROW_PARALLEL and len(core) == 2:
        return _spec(*lead, _fit(core[0], sizes, TP_AXIS),
                     _fit(core[1], sizes, FSDP_AXIS))
    if name in ("conv_w", "conv_b"):
        return _spec(*lead, *([None] * (len(core) - 1)),
                     _fit(core[-1], sizes, TP_AXIS))
    if len(core) == 2:
        # default 2-D: fsdp x tp
        return _spec(*lead, _fit(core[0], sizes, FSDP_AXIS),
                     _fit(core[1], sizes, TP_AXIS))
    return _spec(*lead, *([None] * len(core)))


def _with_paths(tree, path=()):
    """(path names, leaf) in ``tree_flatten``'s leaf order; a list index
    is named ``"segments"``, as the reference's ``param_specs`` names a
    ``SequenceKey``."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _with_paths(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for c in tree:
            yield from _with_paths(c, path + ("segments",))
    else:
        yield path, tree


def _specs(tree, fn):
    _, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(path, tuple(leaf.shape))
                                    for path, leaf in _with_paths(tree)])


def param_specs(params, mesh):
    """Tree of specs matching ``params``; a leaf needs only ``.shape``
    (tensors, DTensors, or abstract shape holders)."""
    return _specs(params, lambda path, shape: spec_for(path, shape, mesh))


# ------------------------- batch / cache specs ------------------------------
def batch_spec(shape, mesh, *, field: str = "tokens") -> tuple:
    """Shard the leading batch dim over (pod, data) as far as it divides."""
    sizes = axis_sizes(mesh)
    b = shape[0]
    total = 1
    used = []
    for a in data_axes(mesh):
        if b % (total * sizes[a]) == 0:
            used.append(a)
            total *= sizes[a]
    return _spec(tuple(used) if used else None, *([None] * (len(shape) - 1)))


def batch_specs(batch_tree, mesh):
    return tree_map(lambda leaf: batch_spec(tuple(leaf.shape), mesh),
                    batch_tree)


def cache_specs(cache_tree, mesh, *, batch: int):
    """KV caches (L, B, S, KV, hd): shard B over the data axes when
    divisible, else S (long-context B = 1); shard KV heads, or else
    head_dim, on model."""
    sizes = axis_sizes(mesh)
    daxes = data_axes(mesh)
    dsize = 1
    for a in daxes:
        dsize *= sizes[a]
    msize = sizes[TP_AXIS]

    def spec(path, shape) -> tuple:
        name = path[-1] if path else ""
        if name in ("k", "v"):          # (L, B, S, KV, hd)
            _, b_, s_, kv_, hd_ = shape
            if b_ % dsize == 0:
                bspec, sspec = daxes, None
            elif s_ % dsize == 0:
                bspec, sspec = None, daxes
            else:
                bspec = sspec = None
            kvspec = TP_AXIS if kv_ % msize == 0 else None
            hdspec = TP_AXIS if kvspec is None and hd_ % msize == 0 \
                else None
            return _spec(None, bspec, sspec, kvspec, hdspec)
        if name == "enc_out":           # (B, Senc, D)
            b_, _, d_ = shape
            return _spec(daxes if b_ % dsize == 0 else None, None,
                         TP_AXIS if d_ % msize == 0 else None)
        if name in ("h", "wkv"):        # SSM / WKV states (L, B, ...)
            b_ = shape[1]
            rest = [None] * (len(shape) - 2)
            # shard the last trailing dim that the model axis divides
            for i in range(len(shape) - 1, 1, -1):
                if shape[i] % msize == 0:
                    rest[i - 2] = TP_AXIS
                    break
            return _spec(None, daxes if b_ % dsize == 0 else None, *rest)
        if name in ("conv", "shift_t", "shift_c"):
            b_ = shape[1]
            return _spec(None, daxes if b_ % dsize == 0 else None,
                         *([None] * (len(shape) - 2)))
        return _spec(*([None] * len(shape)))

    return _specs(cache_tree, spec)


# ------------------------- DTensor placements --------------------------------
def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim ``d`` names that axis (a dim over
    ``("pod", "data")`` shards on both, in mesh order), else
    ``Replicate()``.  An axis of one rank holds the whole dim, so it
    replicates: the same storage, and DTensor then has no shard to
    reason about (some of its views refuse a dim sharded over one
    rank)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh)
    dim_of = {}
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        for a in names:
            if a is not None:
                dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of and sizes[a] > 1
                 else Replicate() for a in mesh.mesh_dim_names)


def spec_leaves(tree, specs) -> list:
    """The specs of ``tree``'s leaves, in its leaf order (a spec tree
    cannot be flattened on its own: its specs are tuples)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [s for k in sorted(tree)
                for s in spec_leaves(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [s for t, sp in zip(tree, specs) for s in spec_leaves(t, sp)]
    return [specs]


def _local_shard(leaf, placements, mesh):
    """This rank's shard of the full ``leaf`` under ``placements``: a view
    (mesh dims in order, each ``Shard(d)`` one of its even chunks along
    ``d``; the rules shard only dims their axis divides)."""
    coord = mesh.get_coordinate()
    local = leaf
    for i, p in enumerate(placements):
        if p.is_shard():
            local = local.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return local


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def distribute_tree(tree, specs, mesh, *, copy: bool = False):
    """Every leaf of ``tree`` as a DTensor on ``mesh`` placed by its spec.
    Each rank takes its own shard of the full leaf it holds (no
    communication): every rank must hold the same full tree, as one made
    from one seed is.  The shard is a view of the caller's leaf (on a
    mesh of one rank, the leaf itself: no memory is added);
    ``copy=True`` gives each DTensor storage of its own."""
    from torch.distributed.tensor import DTensor
    leaves, treedef = tree_flatten(tree)
    out = []
    for leaf, spec in zip(leaves, spec_leaves(tree, specs)):
        pl = placements(spec, mesh)
        local = _local_shard(leaf, pl, mesh)
        if copy:
            local = local.clone()
        whole = tuple(local.shape) == tuple(leaf.shape)
        out.append(DTensor.from_local(
            local, mesh, pl, run_check=False, shape=leaf.shape,
            stride=local.stride() if whole
            else _contiguous_stride(leaf.shape)))
    return tree_unflatten(treedef, out)
