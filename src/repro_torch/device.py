"""Device rule of the port: every entry point runs on the card unless the
caller names another device."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when CUDA is asked for and absent —
    no path moves to the CPU unless the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port on the CPU")
    if dev.type == "cuda" and dev.index is None:
        # tensors report "cuda:<n>", which never equals a bare "cuda"
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def strict_f32(device: torch.device) -> None:
    """On CUDA, turn TF32 off for convolutions and matrix products
    (process-wide): cuDNN runs f32 convolutions in TF32 by default, and
    the port's contract is f32 math, as the reference's."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
