"""Architecture registry of the port.

``ARCH_IDS`` lists only the configs the port runs end to end; the JAX
package's other configs join in their own slices of the port.
"""
from __future__ import annotations

from importlib import import_module

from repro_torch.models.config import ModelConfig

_MODULES = {
    "gemma2-9b": "gemma2_9b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    mod = import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE if smoke else mod.CONFIG
