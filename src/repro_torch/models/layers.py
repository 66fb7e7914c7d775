"""Shared primitive layers (functional, tree-of-tensors params)."""
from __future__ import annotations

from typing import Optional

import numpy as np
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


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm computed in f32 with a ``1 + gamma`` scale, cast back to
    ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def swiglu(x, wi, wg, wo):
    """SwiGLU MLP: silu(x@wg) * (x@wi) @ wo."""
    h = torch.nn.functional.silu(x @ wg) * (x @ wi)
    return h @ wo


# ----------------------------- RoPE ---------------------------------------
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def _tile2_last(t: torch.Tensor, hd: int) -> torch.Tensor:
    """[t, t] along the last dim via broadcast+reshape, as the reference."""
    return t.unsqueeze(-2).expand(*t.shape[:-1], 2, hd // 2) \
            .reshape(*t.shape[:-1], hd)


def rope_tables(positions: torch.Tensor, hd: int, theta: float):
    """``(cos_full, sin_signed)``, each ``(..., S, 1, hd)`` f32, for
    ``positions`` ``(..., S)``: the tables ``apply_rope`` multiplies by.
    A serve step builds them once per tick and hands them to every layer."""
    dev = positions.device
    freqs = torch.from_numpy(rope_freqs(hd, theta)).to(dev)      # (hd/2,)
    ang = positions[..., None].float() * freqs                     # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                             # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    sign = torch.from_numpy(
        np.repeat(np.float32([-1.0, 1.0]), hd // 2)).to(dev)
    return _tile2_last(cos, hd), _tile2_last(sin, hd) * sign


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, *,
               tables=None) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int32.

    Roll-based rotate-half, the reference's form and op order:
    ``out = x·[cos,cos] + roll(x, hd/2)·[−sin,sin]`` in f32, cast back.
    ``tables`` are ``rope_tables(positions, hd, theta)`` when the caller
    already holds them."""
    hd = x.shape[-1]
    cos_full, sin_signed = (tables if tables is not None
                            else rope_tables(positions, hd, theta))
    xf = x.float()
    rot = torch.roll(xf, hd // 2, dims=-1)                         # [x2, x1]
    return (xf * cos_full + rot * sin_signed).to(x.dtype)
