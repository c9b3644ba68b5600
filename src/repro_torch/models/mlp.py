"""Gated MLP (SwiGLU).  The JAX package's gelu branch has no caller on the
paged serving path, so the port carries silu only."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense_init, dtype_of


def mlp_init(generator: torch.Generator, cfg: ModelConfig, device) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, dtype_of(cfg)
    return {
        "w_gate": dense_init(generator, (d, f), dt, device),
        "w_up": dense_init(generator, (d, f), dt, device),
        "w_down": dense_init(generator, (f, d), dt, device),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    return (F.silu(g) * u) @ params["w_down"]
