"""What the prefill kernels' wrappers share: launch and plain-run counts,
the checks before a launch, the meta-device route of a cost count
(``launch.hlo_analysis``), and the ``ctypes`` plumbing."""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

FLOATS = (torch.float32, torch.bfloat16)


class Counts:
    """Kernel launches and plain-version runs per kernel and variant.

    ``launch`` is called where a wrapper launches its kernel and nowhere
    else; ``plain`` where it runs its plain version for CPU tensors;
    ``meta`` where it stands in for a launch on meta tensors under a cost
    count (kept apart: no kernel ran)."""

    def __init__(self, variants: Dict[str, Tuple[str, ...]]):
        self.variants = variants
        self._launches = {k: dict.fromkeys(vs, 0) for k, vs in variants.items()}
        self._plain = {k: dict.fromkeys(vs, 0) for k, vs in variants.items()}
        self._meta = {k: dict.fromkeys(vs, 0) for k, vs in variants.items()}

    def launch(self, kernel: str, variant: str) -> None:
        self._launches[kernel][variant] += 1

    def plain(self, kernel: str, variant: str) -> None:
        self._plain[kernel][variant] += 1

    def meta(self, kernel: str, variant: str) -> None:
        self._meta[kernel][variant] += 1

    def launch_count(self, kernel: Optional[str] = None,
                     variant: Optional[str] = None) -> int:
        return self._count(self._launches, kernel, variant)

    def plain_count(self, kernel: Optional[str] = None,
                    variant: Optional[str] = None) -> int:
        return self._count(self._plain, kernel, variant)

    def meta_count(self, kernel: Optional[str] = None,
                   variant: Optional[str] = None) -> int:
        return self._count(self._meta, kernel, variant)

    def reset(self) -> None:
        for table in (self._launches, self._plain, self._meta):
            for per in table.values():
                for v in per:
                    per[v] = 0

    def _count(self, table, kernel, variant) -> int:
        kernels = self.variants if kernel is None else (kernel,)
        return sum(table[k][v] for k in kernels
                   for v in (self.variants[k] if variant is None
                             else (variant,)))


def variant_of(t: torch.Tensor) -> str:
    return "bf16" if t.dtype == torch.bfloat16 else "f32"


def _counter():
    from repro_torch.launch.hlo_analysis import active
    return active()


def counted_meta(t: torch.Tensor) -> bool:
    """Whether ``t`` takes a wrapper's meta route: a meta tensor while a
    cost count is active.  A meta tensor holds no data, so outside a
    count it is refused like any other device without the kernel."""
    return t.device.type == "meta" and _counter() is not None


def add_work(name: str, work) -> None:
    """Add the kernel's own work to the active cost count, if any:
    ``work()`` gives its (FLOPs, bytes), by the formula beside the
    wrapper."""
    counter = _counter()
    if counter is not None:
        counter.add_kernel(name, *work())


def meta_launch(counts: "Counts", name: str, variant: str, out, work):
    """The meta route of a wrapper, after its checks: ``out`` (an empty
    meta tensor of the kernel's output shape, dtype and layout), the
    kernel's work added to the count, one meta launch counted."""
    add_work(name, work)
    counts.meta(name, variant)
    return out


def check_launchable(name: str, *ts: torch.Tensor,
                     contiguous: bool = True) -> None:
    """Before a launch: every tensor on one CUDA device, contiguous (unless
    the kernel reads strides and checks them itself: ``contiguous=False``),
    and none asking for a gradient (the kernels have no backward: the LMs
    train through the differentiable scans, which ``models.forward(...,
    train=True)`` selects)."""
    dev = ts[0].device
    if dev.type != "cuda" and not counted_meta(ts[0]):
        raise ValueError(f"no {name} kernel for {dev}")
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: the kernel reads contiguous tensors; "
                             f"got strides {t.stride()} for shape "
                             f"{tuple(t.shape)}")
        if t.requires_grad:
            raise RuntimeError(
                f"{name}: the CUDA kernel has no backward; the training "
                "forward runs the differentiable scans instead "
                "(models.forward(..., train=True), as models.loss_fn does), "
                "and a forward without gradients runs under "
                "torch.inference_mode() or on detached inputs")


def strides_of(t: torch.Tensor, dims) -> list:
    """Element strides of ``t`` over ``dims``; a dimension of size 1 takes
    the stride of the dimension inside it times that one's size (its own
    stride is never used, and may be anything)."""
    st = list(t.stride())
    for d in range(t.dim() - 2, -1, -1):
        if t.shape[d] == 1:
            st[d] = st[d + 1] * t.shape[d + 1]
    return [st[d] for d in dims]


def tma_readable(t: torch.Tensor) -> bool:
    """Whether a TMA load reads ``t`` as it lies: a 16-byte-aligned base
    and outer strides of whole 16-byte units (the last dimension
    contiguous is checked apart)."""
    outer = strides_of(t, range(t.dim() - 1))
    return t.data_ptr() % 16 == 0 and \
        all(s * t.element_size() % 16 == 0 for s in outer)


def check_tma(name: str, label: str, t: torch.Tensor) -> None:
    """Refuse a ``t`` that a TMA load cannot read (``tma_readable``)."""
    if not tma_readable(t):
        raise ValueError(f"{name}: the kernel loads {label} by TMA, which "
                         "needs a 16-byte-aligned base and strides of whole "
                         f"16 bytes; got strides {t.stride()} and base "
                         f"offset {t.data_ptr() % 16} for shape "
                         f"{tuple(t.shape)}")


def check_last_contiguous(name: str, label: str, t: torch.Tensor) -> None:
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"{name}: {label} must have a contiguous last "
                         f"dimension; got strides {t.stride()} for shape "
                         f"{tuple(t.shape)}")


def position(name: str, label: str, value, device):
    """A position argument as a kernel takes it: a host int >= 0, or a 0-d
    int32 tensor on ``device``, which the kernel reads there (its value
    never reaches the host: the caller keeps it >= 0)."""
    if isinstance(value, torch.Tensor):
        if value.dim() != 0 or value.dtype != torch.int32 \
                or value.device != device:
            raise ValueError(f"{name}: a tensor {label} must be 0-d int32 "
                             f"on {device}, got {tuple(value.shape)} "
                             f"{value.dtype} on {value.device}")
        return value
    if isinstance(value, bool) or int(value) != value or value < 0:
        raise ValueError(f"{name}: {label} must be an int >= 0 or a 0-d "
                         f"int32 tensor, got {value!r}")
    return int(value)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
