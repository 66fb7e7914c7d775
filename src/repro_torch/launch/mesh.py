"""Device meshes over ``torch.distributed`` (the port of the reference's
``launch/mesh.py``).

The process group comes first: ``init_process_group`` with its address,
world size and rank, which the caller gives (nothing on a host tells a
program of a cluster).  These functions lay the group's ranks out as a
named ``DeviceMesh``.  The card's constants, which the roofline of
``launch/hlo_analysis.py`` prices a step with, live here as the
reference keeps its TPU's in its own ``launch/mesh.py``.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.dtensor import axis_sizes
from repro_torch.device import resolve_device

# NVIDIA H100 SXM5 (NVIDIA's H100 Tensor Core GPU datasheet), per card
PEAK_FLOPS_BF16 = 989e12     # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
NVLINK_LINKS = 18            # NVLink 4 links a card ...
NVLINK_BW = 900e9 / NVLINK_LINKS   # ... 900 GB/s a card in total
IB_BW = 400e9 / 8            # bytes/s, one InfiniBand NDR port (400 Gb/s)
#                              a card between nodes
CARDS_PER_NODE = 8           # an HGX H100 node: 8 cards on one NVLink switch


def axis_links(shape, axes, cards_per_node: int = CARDS_PER_NODE) -> dict:
    """``{axis: "nvlink" or "infiniband"}``: the slowest link each axis of
    a row-major mesh ``shape`` crosses when its ranks fill nodes of
    ``cards_per_node`` in rank order.  An axis stays on NVLink only when
    every group of it lies within one node: its stride times its size is
    at most a node, and a node holds whole groups.  On the 16 x 16
    production mesh (32 nodes of 8) the ``model`` axis (stride 1, 16
    ranks) spans two nodes and ``data`` (stride 16) one rank a node, so
    both cross InfiniBand, as does ``pod``."""
    out, stride = {}, 1
    for name, n in reversed(list(zip(axes, shape))):
        span = stride * n
        inside = n == 1 or (span <= cards_per_node
                            and cards_per_node % span == 0)
        out[name] = "nvlink" if inside else "infiniband"
        stride = span
    return {a: out[a] for a in axes}


def link_bandwidth(link: str) -> float:
    """Bytes/s a card moves over ``link``: all its NVLink links, or its one
    InfiniBand port."""
    return NVLINK_LINKS * NVLINK_BW if link == "nvlink" else IB_BW


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
