"""Architecture registry of the port.

``ARCH_IDS`` lists every config of the JAX package's registry, in its
order: the two embeds configs (a frontend's embeddings in), the two MoE
configs, the four pure-attention token configs and the SSM and hybrid
configs.  ``Shape``, ``SHAPES``, ``LONG_CONTEXT_OK``, ``Cell`` and
``all_cells()`` are the reference's assigned (arch x shape) cells, the
dry run's table (``launch.dryrun``): ``long_500k`` is skipped for pure
full-attention archs, and the skip is recorded, not dropped.
"""
from __future__ import annotations

from dataclasses import dataclass
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


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}

# Archs with bounded-memory attention (SSM / hybrid / SWA / local:global)
# run long_500k; pure full-attention archs skip it.
LONG_CONTEXT_OK = frozenset({
    "mamba2-1.3b", "zamba2-2.7b", "h2o-danube-1.8b", "h2o-danube-3-4b",
    "gemma3-4b", "gemma2-9b",
})


@dataclass(frozen=True)
class Cell:
    arch_id: str
    shape: Shape
    skipped: bool = False
    skip_reason: str = ""

    @property
    def name(self) -> str:
        return f"{self.arch_id}@{self.shape.name}"


def all_cells() -> list[Cell]:
    cells = []
    for arch in ARCH_IDS:
        for shape in SHAPES.values():
            skip = shape.name == "long_500k" and arch not in LONG_CONTEXT_OK
            cells.append(Cell(
                arch_id=arch, shape=shape, skipped=skip,
                skip_reason="pure full-attention arch: 512k dense KV cache "
                            "excluded per assignment" if skip else ""))
    return cells
