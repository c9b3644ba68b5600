"""Data pipeline: deterministic synthetic token / embedding streams.

Port of the JAX package's ``training/data.py``.  ``synthetic_batch`` is a
numpy copy of the reference's: the same seed and step give the same
arrays.  ``ShardedBatcher`` yields each step's batch as tensors on one
device, or with its 2-D leaves placed over a mesh
(``launch.sharding.batch_shardings``).
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
    """Iterator of this host's batches, as tensors on ``device``.

    ``sharding``: a ``launch.sharding.Placement`` for every 2-D leaf, or a
    dict of them by leaf name (``batch_shardings``); those leaves come as
    ``ShardedTensor``s over its mesh, the others stay on ``device``."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig, sharding=None,
                 *, device="cuda") -> None:
        self.cfg, self.dcfg, self.device = cfg, dcfg, torch.device(device)
        self.sharding = sharding
        self.step = 0

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batch = synthetic_batch(self.cfg, self.dcfg, self.step)
        self.step += 1
        out = {k: torch.from_numpy(v).to(self.device)
               for k, v in batch.items()}
        if self.sharding is not None:
            from repro_torch.launch.sharding import reshard

            for k, v in out.items():
                pl = (self.sharding.get(k) if isinstance(self.sharding, dict)
                      else self.sharding)
                if pl is not None and v.dim() == 2:
                    out[k] = reshard(v, pl)
        return out
