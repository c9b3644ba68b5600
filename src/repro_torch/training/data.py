"""Data pipeline: deterministic synthetic token / embedding streams.

Port of the JAX package's ``training/data.py``.  ``synthetic_batch`` is a
numpy copy of the reference's: the same seed and step give the same
arrays.  ``ShardedBatcher`` yields each step's batch as tensors on one
device; placing batches over a mesh waits for the port's mesh (ROADMAP
P11).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class DataConfig:
    batch: int
    seq_len: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


def synthetic_batch(cfg: ModelConfig, dcfg: DataConfig, step: int) -> dict:
    """Deterministic per-step batch: a reproducible fake-corpus stream.

    Tokens follow a skewed Zipf-ish distribution so the softmax/loss path
    sees realistic logits; targets are inputs shifted by one (causal LM).
    """
    rng = np.random.default_rng(dcfg.seed * 1_000_003 + step)
    B, S = dcfg.batch, dcfg.seq_len
    lo = dcfg.host_id * B // dcfg.n_hosts
    hi = (dcfg.host_id + 1) * B // dcfg.n_hosts
    nb = hi - lo
    if cfg.input_mode == "embeds":
        x = rng.standard_normal((nb, S, cfg.d_model), dtype=np.float32)
        inputs = x.astype(np.float32)
        targets = rng.integers(0, cfg.vocab_size, (nb, S), dtype=np.int64)
    else:
        # Zipf over the vocab, clipped
        z = rng.zipf(1.3, size=(nb, S + 1)).astype(np.int64)
        toks = np.minimum(z, cfg.vocab_size - 1)
        inputs, targets = toks[:, :-1], toks[:, 1:]
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (nb, S))
    mask = np.ones((nb, S), np.float32)
    return {
        "inputs": inputs if cfg.input_mode == "embeds" else inputs.astype(np.int32),
        "targets": targets.astype(np.int32),
        "positions": positions.copy(),
        "mask": mask,
    }


class ShardedBatcher:
    """Iterator of this host's batches, as tensors on ``device``."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig, sharding=None,
                 *, device="cuda") -> None:
        if sharding is not None:
            raise NotImplementedError(
                "placing batches over a device mesh waits for the port's "
                "mesh and sharding (ROADMAP P11)")
        self.cfg, self.dcfg, self.device = cfg, dcfg, torch.device(device)
        self.step = 0

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batch = synthetic_batch(self.cfg, self.dcfg, self.step)
        self.step += 1
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}
