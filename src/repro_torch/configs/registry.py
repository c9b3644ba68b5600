"""Architecture registry of the port.

``ARCH_IDS`` lists every config of the JAX package's registry, in its
order: the two embeds configs (a frontend's embeddings in), the two MoE
configs, the four pure-attention token configs and the SSM and hybrid
configs.
"""
from __future__ import annotations

from importlib import import_module

from repro_torch.models.config import ModelConfig

_MODULES = {
    "musicgen-large": "musicgen_large",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "gemma3-4b": "gemma3_4b",
    "gemma2-9b": "gemma2_9b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "mamba2-1.3b": "mamba2_1_3b",
    "zamba2-2.7b": "zamba2_2_7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    mod = import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE if smoke else mod.CONFIG
