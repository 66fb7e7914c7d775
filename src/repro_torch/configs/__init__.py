"""Architecture registry: ``--arch <id>`` -> ModelConfig, and the four
input shapes (``configs/shapes.py``): ``--shape <name>`` -> InputShape.

The port knows every config of the JAX package, in its order: the CNN
``cifar-resnet18`` and the ten LMs — dense (``phi3-mini-3.8b``,
``gemma3-4b``, ``llama3-405b``, ``deepseek-67b``), MoE
(``granite-moe-3b-a800m``, ``arctic-480b``), recurrent and hybrid
(``rwkv6-7b``, ``zamba2-2.7b``), the early-fusion decoder
``chameleon-34b`` and the encoder-decoder ``seamless-m4t-large-v2``.
The largest do not fit one card at full depth: ``launch.specs`` builds
their trees on the meta device."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import InputShape, ModelConfig, TrainConfig, reduced
from repro_torch.configs.shapes import SHAPES

_MODULES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "rwkv6-7b": "rwkv6_7b",
    "deepseek-67b": "deepseek_67b",
    "arctic-480b": "arctic_480b",
    "chameleon-34b": "chameleon_34b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "llama3-405b": "llama3_405b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "gemma3-4b": "gemma3_4b",
    "cifar-resnet18": "cifar_resnet18",
}

ARCH_IDS = tuple(k for k in _MODULES if k != "cifar-resnet18")


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> InputShape:
    return SHAPES[name]


__all__ = ["ARCH_IDS", "SHAPES", "get_config", "get_shape", "reduced",
           "ModelConfig", "TrainConfig", "InputShape"]
