"""ResNet-18 — the paper's evaluation model (CIFAR variant), the port of
the reference's ``models/resnet.py``.

Variable input resolution is supported via global average pooling, which
is exactly the property cyclic progressive learning relies on (§6).

Layouts: the public functions take NHWC images and HWIO conv weights (the
reference's layout, so parameter trees convert one to one).  Internally
the activations are the NCHW-shaped view of the NHWC memory — i.e. PyTorch
``channels_last`` — so cuDNN reads them without a transpose.

Two numerical traps of the reference are reproduced on purpose:

  * XLA's ``padding="SAME"`` is asymmetric at stride 2 (for even sizes it
    pads 0 before and 1 after); ``F.conv2d(padding=1)`` is not the same
    convolution, so ``_same_pads`` computes XLA's split by hand;
  * ``jnp.var`` is the population variance, so the instance norm uses
    ``correction=0``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import dropout, normal_init


def _same_pads(size: int, k: int, stride: int):
    """XLA SAME padding (lo, hi) along one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x: (B, C, H, W) (channels_last view of NHWC); w: HWIO."""
    ph = _same_pads(x.shape[2], w.shape[0], stride)
    pw = _same_pads(x.shape[3], w.shape[1], stride)
    wt = w.permute(3, 2, 0, 1)                    # HWIO -> OIHW
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, wt, stride=stride, padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, wt, stride=stride)


def batch_norm_infer(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """Instance norm + affine: normalizes over the spatial dims per sample,
    so no running stats need to flow anywhere and train/eval behaviour is
    identical (BN substitute at CIFAR scale)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, correction=0)
    xn = (x - mean) * torch.rsqrt(var + eps)
    return xn * p["scale"].view(1, -1, 1, 1) + p["bias"].view(1, -1, 1, 1)


def _init_conv(gen, k, cin, cout, device):
    fan_in = k * k * cin
    return normal_init(gen, (k, k, cin, cout), (2.0 / fan_in) ** 0.5,
                       torch.float32, device)


def _init_bn(c, device):
    return {"scale": torch.ones(c, dtype=torch.float32, device=device),
            "bias": torch.zeros(c, dtype=torch.float32, device=device)}


def _init_basic_block(gen, cin, cout, stride, device):
    p = {
        "conv1": _init_conv(gen, 3, cin, cout, device),
        "bn1": _init_bn(cout, device),
        "conv2": _init_conv(gen, 3, cout, cout, device),
        "bn2": _init_bn(cout, device),
    }
    if stride != 1 or cin != cout:
        p["proj"] = _init_conv(gen, 1, cin, cout, device)
        p["bnp"] = _init_bn(cout, device)
    return p


def init_params(cfg, gen: torch.Generator, width: Optional[int] = None,
                device=None):
    """cfg: ModelConfig with arch_type == 'cnn' (vocab_size = classes).
    Draws from the CPU generator ``gen`` (values differ from the
    reference's ``jax.random`` init; ``repro_torch.convert`` carries the
    reference's parameters over instead).  ``device=None`` means the
    card."""
    device = resolve_device(device)
    w = width or cfg.d_model          # stem width (64 for real ResNet-18)
    widths = [w, 2 * w, 4 * w, 8 * w]
    strides = [1, 2, 2, 2]
    params = {"stem": _init_conv(gen, 3, 3, w, device),
              "bn0": _init_bn(w, device), "stages": []}
    cin = w
    for wo, st in zip(widths, strides):
        blocks = []
        for b in range(2):                   # ResNet-18: two blocks per stage
            blocks.append(_init_basic_block(gen, cin, wo,
                                            st if b == 0 else 1, device))
            cin = wo
        params["stages"].append(blocks)
    params["fc_w"] = normal_init(gen, (cin, cfg.vocab_size), cin ** -0.5,
                                 torch.float32, device)
    params["fc_b"] = torch.zeros(cfg.vocab_size, dtype=torch.float32,
                                 device=device)
    return params


def _basic_block(p, x, stride):
    h = F.relu(batch_norm_infer(conv(x, p["conv1"], stride), p["bn1"]))
    h = batch_norm_infer(conv(h, p["conv2"], 1), p["bn2"])
    if "proj" in p:
        x = batch_norm_infer(conv(x, p["proj"], stride), p["bnp"])
    return F.relu(x + h)


def forward(params, cfg, images: torch.Tensor, *,
            drop_rng: Optional[torch.Generator] = None,
            drop_rate: float = 0.0) -> torch.Tensor:
    """images: (B, H, W, 3) NHWC, any resolution -> logits (B, classes)."""
    x = images.permute(0, 3, 1, 2)               # channels_last view
    x = F.relu(batch_norm_infer(conv(x, params["stem"], 1), params["bn0"]))
    strides = [1, 2, 2, 2]
    for st, blocks in zip(strides, params["stages"]):
        for b, bp in enumerate(blocks):
            x = _basic_block(bp, x, st if b == 0 else 1)
    x = x.mean(dim=(2, 3))                       # global average pool
    if drop_rng is not None and drop_rate > 0.0:
        x = dropout(x, drop_rng, drop_rate)
    return x @ params["fc_w"] + params["fc_b"]


def loss_fn(params, cfg, batch, *, drop_rng=None, drop_rate=0.0):
    """batch: {"images": (B,H,W,3), "labels": (B,), "weight": (B,)?}."""
    logits = forward(params, cfg, batch["images"], drop_rng=drop_rng,
                     drop_rate=drop_rate).float()
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[:, None])[:, 0]
    per_ex = logz - gold
    w = batch.get("weight")
    if w is None:
        w = torch.ones_like(per_ex)
    loss = torch.sum(per_ex * w) / torch.clamp(torch.sum(w), min=1e-9)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc, "per_example": per_ex}
