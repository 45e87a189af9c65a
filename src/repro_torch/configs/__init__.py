"""Architecture registry of the port.

``get_config(name)`` returns the full published config; ``get_smoke(name)``
the reduced same-family config the CPU tests use.  The port serves
granite-3-2b so far; the other architectures of ``repro.configs`` follow
with the model families they need.
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

_MODULES = {
    "granite-3-2b": "granite_3_2b",
}

ARCH_NAMES = list(_MODULES)


def _module(name: str):
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE
