"""Device meshes over ``torch.distributed`` (the port of the reference's
``launch/mesh.py``).

The process group comes first: ``init_process_group`` with its address,
world size and rank, which the caller gives (nothing on a host tells a
program of a cluster).  These functions lay the group's ranks out as a
named ``DeviceMesh``.  The reference's TPU constants stay there; the
card's come with the roofline that uses them (ROADMAP A16).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.dtensor import axis_sizes
from repro_torch.device import resolve_device


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group first")
    return dist.get_world_size()


def _mesh(shape, axes, device) -> DeviceMesh:
    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """16 x 16 = 256 ranks ``("data", "model")``; two pods stack a leading
    ``"pod"`` axis.  Raises when the process group is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    have = _world()
    if have != need:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{need} ranks, the process group has {have}")
    return _mesh(shape, axes, device)


def make_host_mesh(n: int | None = None, axes=("data", "model"),
                   device=None) -> DeviceMesh:
    """``(n // model, model)`` over the process group's ``n`` ranks (its
    world size by default), the model axis the first of 4, 2, 1 that
    divides ``n``.  ``device``: the card unless the caller names
    ``"cpu"`` (gloo ranks)."""
    world = _world()
    dev = world if n is None else int(n)
    if dev != world:
        raise ValueError(f"a mesh of {dev} ranks over a world of {world}")
    model = next(m for m in (4, 2, 1) if dev % m == 0)
    return _mesh((dev // model, model), axes, device)


def data_axes(mesh) -> tuple:
    """Axes that shard the batch dimension."""
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))
