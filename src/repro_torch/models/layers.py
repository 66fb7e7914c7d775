"""Shared primitive layers (functional, tree-of-tensors params)."""
from __future__ import annotations

from typing import Optional

import torch


def normal_init(gen: torch.Generator, shape, scale: float,
                dtype: torch.dtype, device) -> torch.Tensor:
    """``scale · N(0, 1)`` drawn from ``gen`` (a CPU generator, so the
    values do not depend on the device), placed on ``device``."""
    x = scale * torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
    return x.to(dtype=dtype, device=device)


def dropout(x: torch.Tensor, gen: Optional[torch.Generator],
            rate: float) -> torch.Tensor:
    """Inverted dropout; ``gen`` must live on ``x``'s device."""
    if rate == 0.0 or gen is None:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
