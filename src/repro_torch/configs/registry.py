"""Architecture registry of the port.

``ARCH_IDS`` lists only the configs the port runs end to end (the JAX
package's four pure-attention token configs, in its registry's order); the
others join in their own slices of the port.
"""
from __future__ import annotations

from importlib import import_module

from repro_torch.models.config import ModelConfig

_MODULES = {
    "gemma3-4b": "gemma3_4b",
    "gemma2-9b": "gemma2_9b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    mod = import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE if smoke else mod.CONFIG
