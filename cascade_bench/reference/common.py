"""Plain PyTorch building blocks of the references, and the seeded weights
that the benchmark hands to the program and to the references alike.

Nothing here imports the program.  Every product runs in float32 with TF32
off (``f32``); ``fp8`` is the control: each product's weight rounded to
float8 e4m3 with one scale per output column and its input rounded to e4m3
with one scale per row, then multiplied in float32, the precision a later
change might be tempted to serve in.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _e4m3(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """x (..., k) @ w (k, n) in float32 (``w`` of any dtype)."""
    x = x.float()
    w = w.float()
    if mode == "fp8":
        x = _e4m3(x, -1)
        w = _e4m3(w, 0)
    elif mode != "f32":
        raise ValueError(f"unknown precision {mode!r}")
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """Zero-centred scale: y = x / rms(x) * (1 + scale)."""
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (
        1.0 + scale.float())


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding.  x (S, H, D), pos (S,)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64,
                                   device=x.device) / half)
    ang = (pos.double()[:, None] * freq)[:, None, :]
    sin, cos = torch.sin(ang).float(), torch.cos(ang).float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, block: int = 512) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(D)) v over causal pairs, q (S, H, D) and k, v
    (S, K, D) with H a multiple of K; queries in blocks.  (S, H, D)."""
    S, H, D = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)      # (H, S, D)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for a in range(0, S, block):
        b = min(S, a + block)
        s = torch.einsum("qhd,hkd->hqk", q[a:b], k[:, :b]) / math.sqrt(D)
        mask = torch.arange(b, device=q.device)[None, :] > torch.arange(
            a, b, device=q.device)[:, None]
        s = s.masked_fill(mask[None], float("-inf"))
        out[a:b] = torch.einsum("hqk,hkd->qhd", torch.softmax(s, -1), v[:, :b])
    return out


def swiglu(x, p: dict, mode: str) -> torch.Tensor:
    return mm(F.silu(mm(x, p["w_gate"], mode)) * mm(x, p["w_up"], mode),
              p["w_down"], mode)


def attention_block(x, p: dict, pos, *, heads: int, kv_heads: int,
                    head_dim: int, theta: float, mode: str) -> torch.Tensor:
    """QKV projections, rotary embedding, causal attention and the output
    projection of one sequence x (S, d_in)."""
    S = x.shape[0]
    q = mm(x, p["wq"].reshape(x.shape[-1], -1), mode).view(S, heads, head_dim)
    k = mm(x, p["wk"].reshape(x.shape[-1], -1), mode).view(S, kv_heads,
                                                            head_dim)
    v = mm(x, p["wv"].reshape(x.shape[-1], -1), mode).view(S, kv_heads,
                                                            head_dim)
    q, k = rope(q, pos, theta), rope(k, pos, theta)
    o = causal_attention(q, k, v)
    return mm(o.reshape(S, -1), p["wo"].reshape(heads * head_dim, -1), mode)


# ================================================================= weights
def seeded_tree(spec: dict, seed: int, device) -> dict:
    """A nested tree of tensors from ``spec``, nested dicts and lists whose
    leaves are ("randn", shape, fan_in, dtype) / ("zeros" | "ones", shape, dtype):
    every random leaf of one dtype is a view into ONE buffer drawn with one
    ``torch.Generator`` call on ``device`` and scaled by 1/sqrt(fan_in)
    in place; the constant leaves are filled.  Each view starts at a
    multiple of 64 elements."""
    leaves: list[tuple] = []

    def walk(node, out):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for key, val in items:
            if isinstance(val, (dict, list)):
                sub = {} if isinstance(val, dict) else [None] * len(val)
                out[key] = sub
                walk(val, sub)
            else:
                leaves.append((out, key, val))
    tree: dict = {}
    walk(spec, tree)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    by_dtype: dict = {}
    for out, key, leaf in leaves:
        if leaf[0] == "randn":
            by_dtype.setdefault(leaf[3], []).append((out, key, leaf))
        else:
            kind, shape, dt = leaf
            fill = torch.zeros if kind == "zeros" else torch.ones
            out[key] = fill(shape, dtype=dt, device=device)
    for dt in sorted(by_dtype, key=str):
        group = by_dtype[dt]
        sizes = [math.prod(leaf[1]) for _, _, leaf in group]
        starts, n = [], 0
        for s in sizes:
            starts.append(n)
            n += -(-s // 64) * 64
        buf = torch.randn(n, generator=gen, dtype=dt, device=device)
        for (out, key, leaf), a, s in zip(group, starts, sizes):
            view = buf[a:a + s].view(leaf[1])
            if leaf[2] != 1:
                view.mul_(1.0 / math.sqrt(leaf[2]))
            out[key] = view
    return tree



def dtype_of(m: dict) -> torch.dtype:
    """The weights' dtype the configuration states."""
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[m.get("dtype", "bfloat16")]
