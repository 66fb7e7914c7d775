"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Only ``cifar-resnet18`` is ported so far; the LM architectures wait for
the LM slice (ROADMAP A12)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import InputShape, ModelConfig, TrainConfig, reduced

_MODULES = {
    "cifar-resnet18": "cifar_resnet18",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port knows "
                       f"{sorted(_MODULES)} (the LM configs wait for "
                       "ROADMAP A12)")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


__all__ = ["get_config", "reduced", "ModelConfig", "TrainConfig",
           "InputShape"]
