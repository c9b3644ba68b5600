"""Plain reference of zamba2-2.7b (arXiv:2411.15242) as the port lays out
its weights: 9 groups of 6 Mamba-2 layers, each group followed by one
shared attention block (one set of weights) that reads concat(hidden, the
input embeddings), 2·d wide; a tied head.

Mamba-2 (arXiv:2405.21060): in_proj → [z | x | B | C | dt], a causal
depthwise conv and SiLU over (x | B | C), the SSD recurrence
h_t = exp(dt_t·A)·h_{t-1} + dt_t·x_t ⊗ B_t, y_t = C_t·h_t + D·x_t, computed
here by the chunked form in float32 (the quadratic form within a chunk,
the state carried between chunks), then rmsnorm(y · silu(z)) → out_proj.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dtype_of, attention_block, mm, rmsnorm, seeded_tree, swiglu


def _dims(m: dict) -> tuple[int, int, int, int, int]:
    d = m["d_model"]
    di = m["ssm_expand"] * d
    return d, di, m["ssm_state"], di // m["ssm_head_dim"], m["ssm_head_dim"]


def param_spec(m: dict) -> dict:
    bf, f32 = dtype_of(m), torch.float32
    d, di, N, H, P = _dims(m)
    conv = di + 2 * N
    k = m["shared_attn_every"]
    layers = []
    for i in range(m["n_layers"] + m["n_layers"] // k):
        if (i + 1) % (k + 1) == 0:
            layers.append({})
            continue
        layers.append({"norm": {"scale": ("zeros", (d,), f32)},
                       "mamba": {
            "in_proj": ("randn", (d, 2 * di + 2 * N + H), d, bf),
            "conv_w": ("randn", (m["conv_width"], conv), m["conv_width"], bf),
            "conv_b": ("zeros", (conv,), bf),
            "A_log": ("zeros", (H,), f32),
            "D": ("ones", (H,), f32),
            "dt_bias": ("zeros", (H,), f32),
            "out_norm": {"scale": ("zeros", (di,), f32)},
            "out_proj": ("randn", (di, d), di, bf)}})
    d2, Ha, Ka, Da, ff = 2 * d, m["n_heads"], m["n_kv_heads"], m["head_dim"], \
        m["d_ff"]
    shared = {"norm_attn": {"scale": ("zeros", (d2,), f32)},
              "attn": {"wq": ("randn", (d2, Ha, Da), d2, bf),
                       "wk": ("randn", (d2, Ka, Da), d2, bf),
                       "wv": ("randn", (d2, Ka, Da), d2, bf),
                       "wo": ("randn", (Ha, Da, d), Ha * Da, bf)},
              "norm_mlp": {"scale": ("zeros", (d2,), f32)},
              "mlp": {"w_gate": ("randn", (d2, ff), d2, bf),
                      "w_up": ("randn", (d2, ff), d2, bf),
                      "w_down": ("randn", (ff, d), ff, bf)}}
    # embedding rows N(0, 1/d): the tied head then gives logits of unit
    # scale; N(0, 1) rows would make greedy decoding copy the input token
    return {"embed": {"table": ("randn", (m["vocab_size"], d), d, bf)},
            "final_norm": {"scale": ("zeros", (d,), f32)}, "layers": layers,
            "shared_attn": shared}


def make_params(m: dict, seed: int, device) -> dict:
    return seeded_tree(param_spec(m), seed, device)


def ssd(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    """y (S, H, P) of the SSD recurrence from h_0 = 0: x (S, H, P), dt
    (S, H), A (H,), B and C (S, N); float32, in chunks of ``chunk``."""
    S, H, P = x.shape
    y = torch.empty_like(x)
    h = x.new_zeros((H, P, B.shape[1]))
    for a in range(0, S, chunk):
        b = min(S, a + chunk)
        cum = torch.cumsum(dt[a:b] * A, dim=0)                   # (L, H)
        xdt = x[a:b] * dt[a:b, :, None]                          # (L, H, P)
        L = b - a
        decay = torch.exp(cum[:, None, :] - cum[None, :, :])     # (i, j, H)
        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        decay = torch.where(causal[:, :, None], decay, 0.0)
        cb = C[a:b] @ B[a:b].t()                                 # (i, j)
        y[a:b] = torch.einsum("ijh,jhp->ihp", decay * cb[:, :, None], xdt)
        y[a:b] += torch.einsum("in,hpn->ihp", C[a:b], h) * torch.exp(
            cum)[:, :, None]
        last = torch.exp(cum[-1][None, :] - cum)                 # (j, H)
        h = h * torch.exp(cum[-1])[:, None, None] + torch.einsum(
            "jhp,jn->hpn", last[:, :, None] * xdt, B[a:b])
    return y


def mamba(x, p: dict, m: dict, mode: str) -> torch.Tensor:
    d, di, N, H, P = _dims(m)
    S = x.shape[0]
    proj = mm(x, p["in_proj"], mode)
    z, xbc, dt = proj[:, :di], proj[:, di:2 * di + 2 * N], proj[:, -H:]
    dt = F.softplus(dt + p["dt_bias"].float())
    W = p["conv_w"].shape[0]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    w = p["conv_w"].float()
    xbc = F.silu(sum(pad[i:i + S] * w[i] for i in range(W))
                 + p["conv_b"].float())
    xs = xbc[:, :di].reshape(S, H, P)
    A = -torch.exp(p["A_log"].float())
    y = ssd(xs, dt, A, xbc[:, di:di + N], xbc[:, di + N:], m["ssm_chunk"])
    y = y + p["D"].float()[None, :, None] * xs
    y = y.reshape(S, di) * F.silu(z)
    return mm(rmsnorm(y, p["out_norm"]["scale"]), p["out_proj"], mode)


def logits(params: dict, m: dict, tokens: torch.Tensor, at: torch.Tensor,
           mode: str = "f32") -> torch.Tensor:
    """f32 logits (len(at), V) of the rows ``at`` of one sequence
    ``tokens`` (S,) read from position 0."""
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    e0 = params["embed"]["table"][tokens.long()].float()
    x = e0
    sa = params["shared_attn"]
    kw = dict(heads=m["n_heads"], kv_heads=m["n_kv_heads"],
              head_dim=m["head_dim"], theta=m["rope_theta"], mode=mode)
    for layer in params["layers"]:
        if not layer:
            u = rmsnorm(torch.cat([x, e0], -1), sa["norm_attn"]["scale"])
            x = x + attention_block(u, sa["attn"], pos, **kw)
            v = rmsnorm(torch.cat([x, e0], -1), sa["norm_mlp"]["scale"])
            x = x + swiglu(v, sa["mlp"], mode)
        else:
            x = x + mamba(rmsnorm(x, layer["norm"]["scale"]), layer["mamba"],
                          m, mode)
    h = rmsnorm(x[at], params["final_norm"]["scale"])
    return mm(h, params["embed"]["table"].t(), mode)
