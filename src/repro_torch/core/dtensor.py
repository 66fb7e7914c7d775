"""Layer-free DTensor helpers that the kernels, the models, the steps and
the launcher share.  Each is the identity on a plain tensor, and the
module imports no part of ``torch.distributed`` until one is called."""
from __future__ import annotations


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, or of a stand-in whose
    ``shape`` is already that dict (the sharding rules need no ranks)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local(t):
    """A DTensor's local shard (its storage, no copy), a tensor as it
    is."""
    return t.to_local() if is_dtensor(t) else t


def place_like(g, p):
    """``g`` on the placements of ``p`` (both DTensors on one mesh; a
    plain ``p`` leaves ``g`` as it is).  On a mesh of one rank every
    placement holds the whole tensor, so the local tensor is rewrapped
    as it is: no collective and no copy."""
    if not is_dtensor(p) or tuple(g.placements) == tuple(p.placements):
        return g
    if p.device_mesh.size() == 1:
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(g.to_local(), p.device_mesh, p.placements,
                                  run_check=False)
    return g.redistribute(p.device_mesh, p.placements)
