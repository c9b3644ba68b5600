"""Gated MLP (SwiGLU).  The JAX package's gelu branch has no caller on the
paged serving path, so the port carries silu only."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense_init, dtype_of


def mlp_init(generator: torch.Generator, cfg: ModelConfig, device, *,
             d_in: int | None = None, d_out: int | None = None,
             d_ff: int | None = None) -> dict:
    """``d_in``/``d_out`` default to d_model and ``d_ff`` to cfg.d_ff;
    zamba2's shared block reads concat(hidden, embeddings), 2·d_model wide,
    and a MoE layer's shared experts are one MLP n_shared_experts ·
    moe_d_ff wide."""
    d_in, d_out = d_in or cfg.d_model, d_out or cfg.d_model
    f, dt = d_ff or cfg.d_ff, dtype_of(cfg)
    return {
        "w_gate": dense_init(generator, (d_in, f), dt, device),
        "w_up": dense_init(generator, (d_in, f), dt, device),
        "w_down": dense_init(generator, (f, d_out), dt, device),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    return (F.silu(g) * u) @ params["w_down"]
