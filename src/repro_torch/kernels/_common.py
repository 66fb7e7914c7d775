"""What the prefill kernels' wrappers share: launch and plain-run counts,
the checks before a launch, and the ``ctypes`` plumbing."""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

FLOATS = (torch.float32, torch.bfloat16)


class Counts:
    """Kernel launches and plain-version runs per kernel and variant.

    ``launch`` is called where a wrapper launches its kernel and nowhere
    else; ``plain`` where it runs its plain version for CPU tensors."""

    def __init__(self, variants: Dict[str, Tuple[str, ...]]):
        self.variants = variants
        self._launches = {k: dict.fromkeys(vs, 0) for k, vs in variants.items()}
        self._plain = {k: dict.fromkeys(vs, 0) for k, vs in variants.items()}

    def launch(self, kernel: str, variant: str) -> None:
        self._launches[kernel][variant] += 1

    def plain(self, kernel: str, variant: str) -> None:
        self._plain[kernel][variant] += 1

    def launch_count(self, kernel: Optional[str] = None,
                     variant: Optional[str] = None) -> int:
        return self._count(self._launches, kernel, variant)

    def plain_count(self, kernel: Optional[str] = None,
                    variant: Optional[str] = None) -> int:
        return self._count(self._plain, kernel, variant)

    def reset(self) -> None:
        for table in (self._launches, self._plain):
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


def check_launchable(name: str, *ts: torch.Tensor,
                     contiguous: bool = True) -> None:
    """Before a launch: every tensor on one CUDA device, contiguous (unless
    the kernel reads strides and checks them itself: ``contiguous=False``),
    and none asking for a gradient (the kernels have no backward: the LMs
    train through the differentiable scans, which ``models.forward(...,
    train=True)`` selects)."""
    dev = ts[0].device
    if dev.type != "cuda":
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


def check_tma(name: str, label: str, t: torch.Tensor) -> None:
    """What a TMA load needs of ``t``: a 16-byte-aligned base and outer
    strides of whole 16-byte units (the last dimension contiguous is
    checked by the caller).  Anything else is refused."""
    outer = strides_of(t, range(t.dim() - 1))
    if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in outer):
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


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
