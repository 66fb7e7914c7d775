"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The port knows ``cifar-resnet18`` (the training slices), the two
attention-only LMs of the serving slice, ``phi3-mini-3.8b`` and
``gemma3-4b``, the recurrent and hybrid LMs of the prefill slice,
``zamba2-2.7b`` and ``rwkv6-7b`` (all four train since the LM training
slice), the MoE LM ``granite-moe-3b-a800m`` (every LM path) and the
encoder-decoder ``seamless-m4t-large-v2`` (``models/encdec.py``); the
other LM configs (llama3-405b, deepseek-67b, arctic-480b, chameleon-34b)
wait for ROADMAP A12e."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import InputShape, ModelConfig, TrainConfig, reduced

_MODULES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "rwkv6-7b": "rwkv6_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "gemma3-4b": "gemma3_4b",
    "cifar-resnet18": "cifar_resnet18",
}

ARCH_IDS = tuple(k for k in _MODULES if k != "cifar-resnet18")


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port knows "
                       f"{sorted(_MODULES)} (the other LM configs wait for "
                       "ROADMAP A12e)")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


__all__ = ["ARCH_IDS", "get_config", "reduced", "ModelConfig", "TrainConfig",
           "InputShape"]
