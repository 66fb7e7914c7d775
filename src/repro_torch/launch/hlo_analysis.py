"""A step's cost counted on each rank, and its roofline on the card (the
port of the reference's ``launch/hlo_analysis.py``; the name is kept so
that a reader finds the counterpart).

The reference reads the optimized HLO text of a compiled step: it splits
the module into computations, weights each while body by its
``known_trip_count`` (XLA's own ``cost_analysis`` counts a scanned layer
stack once) and costs every ``dot``, ``gather`` and collective.  The
port compiles nothing: a step runs eagerly, so the counter here is a
``TorchDispatchMode`` (``with CostCounter(mesh) as c: step(...)``, then
``c.cost``) over one run of the step, which sees every aten op as it is dispatched.  A
loop dispatches every iteration, so the trip-count problem cannot arise:
an op in a loop of 8 is seen 8 times.  ``raw_cost_analysis`` has no
counterpart, since there is no compiled module to ask.

What is counted, per rank (the reference's numbers are per device, from
the partitioned module):

* ``flops``: every product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, the
  convolutions, ``_scaled_dot_product_*`` and their backwards) by the
  formulas ``torch.utils.flop_counter`` registers — 2 x result elements x
  contraction for a product, as the reference counts ``dot``.  A DTensor
  op is not counted itself: DTensor runs it on each rank's local shards,
  and those local ops are what is counted (``FlopCounterMode`` would
  count the global op).  A replicated op counts whole on every rank.
  The ops DTensor's sharding propagation runs on fake tensors are not
  counted.
* ``dot_bytes``: each product's operand bytes plus its result bytes,
  plus the result bytes of ``gather``, ``index_select``, ``index`` and
  ``embedding`` (the reference's ``gather`` and ``dynamic-slice``).
* ``dot_bytes_flash``: the same, except that a kernel's intermediates
  never reach device memory (the reference's reason for the field).
  A hand-written kernel is opaque to the dispatcher: its wrapper adds its
  own work (``add_kernel``: the FLOPs and bytes of the formula beside the
  wrapper, each input read once and each output written once) to both.
  Where the plain form of a kernel runs instead (the training scans, the
  CPU), ``fused`` marks the call: products inside it count only operands
  whose storage came from outside it, and its outputs once.  The
  backward of such a call is counted in full.
* collectives: the result-shape bytes of every functional collective
  (``all_gather_into_tensor``, ``all_reduce``, ``reduce_scatter_tensor``,
  ``all_to_all_single`` and DTensor's ``shard_dim_alltoall``,
  ``broadcast``) by kind, by count and by mesh axis, under the
  reference's kind names.  The reference counts its collectives the same
  way.

``roofline_terms`` prices the counts on the card's constants
(``launch/mesh.py``): FLOPs over the dense bf16 rate, bytes over the HBM
rate, and each mesh axis's collective bytes over the slowest link that
axis crosses (``mesh.axis_links``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import (HBM_BW, IB_BW, PEAK_FLOPS_BF16,
                                     axis_links, link_bandwidth)

COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast",
}
_GATHERS = {"gather", "index_select", "index", "embedding"}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "_dtensor")

_ACTIVE: list = []


@dataclass
class HloCost:
    flops: float = 0.0
    dot_bytes: float = 0.0              # product / gather operand+result traffic
    collective_bytes: float = 0.0
    collective_by_kind: dict = field(default_factory=dict)
    collective_counts: dict = field(default_factory=dict)
    # dot_bytes without the intermediates a kernel keeps on chip
    dot_bytes_flash: float = 0.0
    collective_by_axis: dict = field(default_factory=dict)
    # per kernel: {"launches", "flops", "bytes"} that its wrapper added
    kernels: dict = field(default_factory=dict)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def _storage(t):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


class CostCounter(TorchDispatchMode):
    """Counts the work of the ops dispatched while it is active, on each
    rank's local tensors (see the module docstring).  ``mesh`` names the
    axis of each collective's process group; without it every collective
    counts under ``"other"``."""

    def __init__(self, mesh=None):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor = DTensor
        self._flops = flop_registry
        self.cost = HloCost()
        self._axis_of = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                self._axis_of[mesh.get_group(i).group_name] = name
        self._region = 0
        self._inside = set()

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- what the wrappers and the plain forms call -------------------------
    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        self.cost.flops += flops
        self.cost.dot_bytes += nbytes
        self.cost.dot_bytes_flash += nbytes
        rec = self.cost.kernels.setdefault(
            name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        rec["launches"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes

    @contextlib.contextmanager
    def _fused(self):
        self._region += 1
        try:
            yield
        finally:
            self._region -= 1
            if not self._region:
                self._inside.clear()

    # -- the dispatch -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            # DTensor runs the op on the local shards: count those
            return NotImplemented
        out = func(*args, **kwargs)
        ins = list(_tensors(list(args) + list(kwargs.values())))
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None \
                or any(hasattr(t, "_spec") for t in ins):
            # DTensor's sharding propagation: on fake tensors, or tracing
            # a decomposition on meta tensors that carry a ``_spec``
            return out
        self._account(func, ins, args, kwargs, out)
        return out

    def _account(self, func, ins, args, kwargs, out):
        packet = func._overloadpacket
        outs = list(_tensors(out if isinstance(out, (list, tuple))
                             else (out,)))
        c = self.cost
        if packet in self._flops:
            c.flops += self._flops[packet](*args, **kwargs, out_val=out)
            b = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            c.dot_bytes += b
            if self._region:
                b = sum(_nbytes(t) for t in ins
                        if _storage(t) not in self._inside)
            c.dot_bytes_flash += b
        else:
            ns, name = func.namespace, func._schema.name.split("::")[-1]
            if ns == "aten" and name in _GATHERS:
                b = sum(_nbytes(t) for t in outs)
                c.dot_bytes += b
                if not self._region:
                    c.dot_bytes_flash += b
            elif ns in _COLLECTIVE_NAMESPACES and name in COLLECTIVE_KINDS:
                self._collective(COLLECTIVE_KINDS[name], args, outs)
        if self._region:
            self._inside.update(_storage(t) for t in outs)

    def _collective(self, kind, args, outs):
        c = self.cost
        b = sum(_nbytes(t) for t in outs)
        group = args[-1]
        group = group if isinstance(group, str) \
            else getattr(group, "group_name", str(group))
        axis = self._axis_of.get(group, "other")
        c.collective_bytes += b
        c.collective_by_kind[kind] = c.collective_by_kind.get(kind, 0.0) + b
        c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1
        c.collective_by_axis[axis] = c.collective_by_axis.get(axis, 0.0) + b


def active():
    """The innermost active counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def fused(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``: the plain form of work a kernel does on
    chip.  Under an active count its intermediates are left out of
    ``dot_bytes_flash`` and its tensor outputs are written once; without
    one, just the call."""
    counter = active()
    if counter is None:
        return fn(*args, **kwargs)
    with counter._fused():
        out = fn(*args, **kwargs)
    b = sum(_nbytes(t) for t in _tensors(out if isinstance(out, (list, tuple))
                                         else (out,)))
    counter.cost.dot_bytes_flash += b
    return out


@dataclass
class Roofline:
    """Three-term roofline (seconds) for one step on the full mesh."""
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float          # whole-step, all devices
    hlo_bytes: float
    collective_bytes: float   # per-device
    model_flops: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_terms(*, per_device_flops: float, per_device_bytes: float,
                   per_device_collective_bytes: float, n_chips: int,
                   model_flops: float, peak_flops: float = PEAK_FLOPS_BF16,
                   hbm_bw: float = HBM_BW,
                   collective_by_axis: dict | None = None,
                   axis_bw: dict | None = None) -> Roofline:
    """All inputs are per card; ``model_flops`` is the global 6ND (2ND)
    number of the step.  The collective term: with ``collective_by_axis``
    and ``axis_bw`` (bytes/s of the slowest link each axis crosses,
    ``mesh_axis_bandwidth``) each axis's bytes over its link, summed;
    otherwise all the bytes over the card's InfiniBand port, the slowest
    link of the production meshes."""
    if collective_by_axis is not None and axis_bw is not None:
        coll_s = sum(b / axis_bw.get(a, IB_BW)
                     for a, b in collective_by_axis.items())
    else:
        coll_s = per_device_collective_bytes / IB_BW
    return Roofline(
        compute_s=per_device_flops / peak_flops,
        memory_s=per_device_bytes / hbm_bw,
        collective_s=coll_s,
        hlo_flops=per_device_flops * n_chips,
        hlo_bytes=per_device_bytes * n_chips,
        collective_bytes=per_device_collective_bytes,
        model_flops=model_flops)


def mesh_axis_bandwidth(mesh) -> dict:
    """``{axis: bytes/s}``: each axis of ``mesh`` priced at the slowest
    link it crosses (``launch.mesh.axis_links``)."""
    links = axis_links(tuple(mesh.shape), tuple(mesh.mesh_dim_names))
    return {a: link_bandwidth(l) for a, l in links.items()}
