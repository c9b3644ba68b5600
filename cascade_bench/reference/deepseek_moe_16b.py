"""Plain reference of deepseek-moe-16b (arXiv:2401.06066) as the port lays
out its weights: a dense first layer, then layers of 64 routed experts
(top 6, weights renormalised) plus 2 shared ones, every layer pre-norm
attention and pre-norm FFN, an untied head.

Routing runs in float32 over softmax probabilities; every routed entry is
computed (no capacity: the published model is dropless).  One sequence at
a time, layer by layer, in float32 (or the ``fp8`` control).
"""
from __future__ import annotations

import torch

from .common import dtype_of, attention_block, mm, rmsnorm, seeded_tree, swiglu


def param_spec(m: dict) -> dict:
    bf, f32 = dtype_of(m), torch.float32
    d, H, K, D = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    E, ff = m["n_experts"], m["moe_d_ff"]
    sff = m["n_shared_experts"] * ff

    def attn():
        return {"wq": ("randn", (d, H, D), d, bf),
                "wk": ("randn", (d, K, D), d, bf),
                "wv": ("randn", (d, K, D), d, bf),
                "wo": ("randn", (H, D, d), H * D, bf)}

    def mlp(f):
        return {"w_gate": ("randn", (d, f), d, bf),
                "w_up": ("randn", (d, f), d, bf),
                "w_down": ("randn", (f, d), f, bf)}

    norm = lambda: {"scale": ("zeros", (d,), f32)}
    layers = []
    for i in range(m["n_layers"]):
        layer = {"norm_attn": norm(), "attn": attn(), "norm_mlp": norm()}
        if i == 0 and m["first_layer_dense"]:
            layer["mlp"] = mlp(m["d_ff"])
        else:
            layer["moe"] = {"router": ("randn", (d, E), d, f32),
                            "w_gate": ("randn", (E, d, ff), d, bf),
                            "w_up": ("randn", (E, d, ff), d, bf),
                            "w_down": ("randn", (E, ff, d), ff, bf),
                            "shared": mlp(sff)}
        layers.append(layer)
    return {"embed": {"table": ("randn", (m["vocab_size"], d), 1, bf)},
            "final_norm": norm(), "layers": layers,
            "head": {"table": ("randn", (m["vocab_size"], d), 1, bf)}}


def make_params(m: dict, seed: int, device) -> dict:
    return seeded_tree(param_spec(m), seed, device)


def moe(x, p: dict, m: dict, mode: str) -> torch.Tensor:
    """Every token through its top-k routed experts, weighted, plus the
    shared experts."""
    probs = torch.softmax(mm(x, p["router"], mode), dim=-1)
    w, idx = torch.topk(probs, m["top_k"], dim=-1)
    w = w / w.sum(-1, keepdim=True)
    y = swiglu(x, p["shared"], mode)
    for e in range(m["n_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            pe = {k: p[k][e] for k in ("w_gate", "w_up", "w_down")}
            y.index_add_(0, tok, w[tok, slot, None] * swiglu(x[tok], pe,
                                                             mode))
    return y


def logits(params: dict, m: dict, tokens: torch.Tensor, at: torch.Tensor,
           mode: str = "f32") -> torch.Tensor:
    """f32 logits (len(at), V) of the rows ``at`` of one sequence
    ``tokens`` (S,) read from position 0."""
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = params["embed"]["table"][tokens.long()].float()
    kw = dict(heads=m["n_heads"], kv_heads=m["n_kv_heads"],
              head_dim=m["head_dim"], theta=m["rope_theta"], mode=mode)
    for layer in params["layers"]:
        x = x + attention_block(rmsnorm(x, layer["norm_attn"]["scale"]),
                                layer["attn"], pos, **kw)
        h = rmsnorm(x, layer["norm_mlp"]["scale"])
        x = x + (moe(h, layer["moe"], m, mode) if "moe" in layer
                 else swiglu(h, layer["mlp"], mode))
    h = rmsnorm(x[at], params["final_norm"]["scale"])
    return mm(h, params["head"]["table"].t(), mode)
