"""The yardstick's arithmetic: the card's peaks, the operations and bytes a
kernel or a model step needs, and what each tick of a run carried.

Work is counted from the lengths the traffic had (the prompt and output
tokens each tick processed, at their positions), never from the program's
lanes, padding or capacity slots.  The kernel counts are frozen copies of
the port's ``work`` functions (``kernels/decode_attention/ops.py``,
``kernels/ssd/ops.py``), evaluated on those lengths.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


# ================================================================ kernels
def k1_call(blocks: int, visible: int, tokens: int, rows: int, nb: int,
            bs: int, h: int, kv: int, d: int, item: int = 2):
    """(flops, bytes) of one K1 call that reads ``blocks`` distinct pool
    blocks and attends ``visible`` (token, position) pairs of ``tokens``
    real tokens: each block once for all kv heads, q read and out written
    once, the block table and the tokens' positions and rows once; two
    products of 2·D flops per visible pair and head."""
    nbytes = (blocks * bs * kv * 2 * d * item + 2 * tokens * h * d * item
              + rows * nb * 4 + 2 * tokens * 4)
    return visible * h * 4 * d, nbytes


def k3_call(B: int, S: int, H: int, P: int, N: int, Q: int, item: int = 2):
    """(flops, bytes) of one K3 call over B rows of S tokens from a zero
    state, with no D-term (the Mamba-2 block adds it itself)."""
    nbytes = (B * S * H * P * (item + 4) + 2 * B * S * N * item
              + B * S * H * 4 + H * 4 + B * H * P * N * 4)
    flops = 0
    for c0 in range(0, S, Q):
        L = min(Q, S - c0)
        pairs = L * (L + 1) // 2
        flops += 2 * N * pairs + H * (2 * P * pairs + 4 * L * P * N)
    return B * flops, nbytes


# ============================================================= the model
def linear_flops_per_token(m: dict) -> float:
    """2 x the weights one token multiplies through in every layer (the
    routed experts it is sent to, the shared ones, the router), without
    attention's pairs and the head."""
    d, H, K, D = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    if m["family"] == "moe":
        attn = d * H * D + 2 * d * K * D + H * D * d
        ff = m["moe_d_ff"]
        moe = (d * m["n_experts"] + m["top_k"] * 3 * d * ff
               + 3 * d * m["n_shared_experts"] * ff)
        dense = 3 * d * m["d_ff"]
        n = m["n_layers"]
        lead = 1 if m.get("first_layer_dense") else 0
        return 2.0 * (n * attn + lead * dense + (n - lead) * moe)
    if m["family"] == "hybrid":
        di, N = m["ssm_expand"] * d, m["ssm_state"]
        Hs = di // m["ssm_head_dim"]
        mamba = (d * (2 * di + 2 * N + Hs) + di * d
                 + m["conv_width"] * (di + 2 * N))
        d2 = 2 * d
        shared = (d2 * H * D + 2 * d2 * K * D + H * D * d
                  + 2 * d2 * m["d_ff"] + m["d_ff"] * d)
        apps = m["n_layers"] // m["shared_attn_every"]
        return 2.0 * (m["n_layers"] * mamba + apps * shared)
    raise ValueError(f"no FLOP count for family {m['family']!r}")


def attention_layers(m: dict) -> int:
    if m["family"] == "hybrid":
        return m["n_layers"] // m["shared_attn_every"]
    return m["n_layers"]


def head_flops(m: dict) -> float:
    return 2.0 * m["d_model"] * m["vocab_size"]


def ssm_dims(m: dict) -> tuple[int, int, int]:
    di = m["ssm_expand"] * m["d_model"]
    return di // m["ssm_head_dim"], m["ssm_head_dim"], m["ssm_state"]


# ================================================ what each tick carried
@dataclass
class TickWork:
    """The tokens one tick processed: each decode row's position, and each
    prompt piece as (prompt length, first position, tokens)."""
    decode: list = field(default_factory=list)
    prefill: list = field(default_factory=list)
    emitted: int = 0

    @property
    def tokens(self) -> int:
        return len(self.decode) + sum(t for _, _, t in self.prefill)

    def visible(self) -> int:
        """(token, position) pairs of causal attention this tick."""
        v = sum(p + 1 for p in self.decode)
        for _, a, t in self.prefill:
            v += t * a + t * (t + 1) // 2
        return v


def tick_work(run) -> list[TickWork]:
    """Each tick's ``TickWork``, from the harness's records: a decode row
    is a token (after the first) stamped at that tick, at position
    prompt + its index - 1; the prompt tokens a tick prefilled (the
    engine's ``prefill_tokens`` counter) are the next ones of the prompt
    stream in send order, which is the order both engines admit and chunk
    a single class of requests in."""
    out = [TickWork() for _ in run.ticks]
    stream = iter([r for r in run.records
                   if r.token_ticks or not r.error])
    cur, done = None, 0
    for k, (_, _, prefilled, _) in enumerate(run.ticks):
        left = prefilled
        while left > 0:
            if cur is None or done == len(cur.item.prompt):
                cur, done = next(stream), 0
            S = len(cur.item.prompt)
            take = min(left, S - done)
            out[k].prefill.append((S, done, take))
            done += take
            left -= take
    for rec in run.records:
        S = len(rec.item.prompt)
        for i, k in enumerate(rec.token_ticks):
            out[k].emitted += 1
            if i:
                out[k].decode.append(S + i - 1)
    return out


def model_flops(m: dict, w: TickWork) -> float:
    """Logical FLOPs of one tick: every token through the layers, its
    attention pairs, the SSD work of the prompts and decode rows of a
    Mamba-2 model, and the head for every emitted token."""
    f = w.tokens * linear_flops_per_token(m)
    f += 4.0 * m["n_heads"] * m["head_dim"] * w.visible() * attention_layers(m)
    if m["family"] == "hybrid":
        H, P, N = ssm_dims(m)
        for S, a, t in w.prefill:
            f += m["n_layers"] * k3_call(1, t, H, P, N, m["ssm_chunk"])[0]
        f += m["n_layers"] * len(w.decode) * 6.0 * H * P * N
    return f + w.emitted * head_flops(m)


def k1_bound_s(m: dict, eng: dict, w: TickWork) -> float:
    """The least time of a tick's K1 calls (one a layer)."""
    if not w.tokens:
        return 0.0
    bs = eng["block_size"]
    last = [p for p in w.decode] + [a + t - 1 for _, a, t in w.prefill]
    blocks = sum(p // bs + 1 for p in last)
    flops, nbytes = k1_call(blocks, w.visible(), w.tokens, eng["n_slots"],
                            -(-eng["max_len"] // bs), bs, m["n_heads"],
                            m["n_kv_heads"], m["head_dim"])
    return m["n_layers"] * bound_s(flops, nbytes)


def k3_bound_s(m: dict, w: TickWork) -> float:
    """The least time of a tick's K3 calls: one a Mamba-2 layer for each
    group of consecutive equal-length whole prompts (a dense prefill)."""
    H, P, N = ssm_dims(m)
    total, groups = 0.0, []
    for S, a, t in w.prefill:
        if groups and groups[-1][0] == t:
            groups[-1][1] += 1
        else:
            groups.append([t, 1])
    for t, B in groups:
        total += bound_s(*k3_call(B, t, H, P, N, m["ssm_chunk"]))
    return m["n_layers"] * total
