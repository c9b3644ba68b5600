"""What decides ``correct`` for a served model: once the window has
closed, a sample (drawn from the seed) of the requests the program
finished, the longest among them, is run through the plain reference,
prompt and served tokens as one sequence.  The number compared is the
gap by which a served token's logit lies below the reference's best at
its position: 0 where the program served the reference's own greedy
choice.  Every finished request must also have served exactly the tokens
it asked for.

The control (``control.py``) takes the program's place: the tokens that
the reference computed in float8 puts first, at the same positions of the
same sequences, are scored by the same gap and held by the same
``checks`` and ``passed``.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

MIN_TOKENS = 400
MIN_REQUESTS = 4
MAX_REQUESTS = 8
# a run compares at least this many served tokens
MIN_COMPARED = 100


def reference(config: dict):
    return importlib.import_module(
        f"cascade_bench.reference.{config['reference']}")


def sample(records: list, seed: int) -> list:
    """The finished requests to compare: the one with the most served
    tokens, then others in an order drawn from the seed, until both
    ``MIN_TOKENS`` served tokens and ``MIN_REQUESTS`` requests (so that
    several slots are compared), or ``MAX_REQUESTS`` requests."""
    done = [r for r in records if r.done and not r.error]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.req.tokens), -r.item.index))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([seed, 1])
    picks, total = [longest], len(longest.req.tokens)
    for i in rng.permutation(len(rest)):
        if (total >= MIN_TOKENS and len(picks) >= MIN_REQUESTS
                or len(picks) >= MAX_REQUESTS):
            break
        picks.append(rest[int(i)])
        total += len(rest[int(i)].req.tokens)
    return picks


def sequences(picks: list, device):
    """For each pick: (the sequence prompt + served[:-1], the rows whose
    logits predict the served tokens, the served tokens)."""
    out = []
    for r in picks:
        served = np.asarray(r.req.tokens, dtype=np.int64)
        seq = np.concatenate([r.item.prompt.astype(np.int64), served[:-1]])
        at = np.arange(len(r.item.prompt) - 1, len(seq))
        out.append((torch.from_numpy(seq).to(device),
                    torch.from_numpy(at).to(device),
                    torch.from_numpy(served).to(device)))
    return out


def gap_of(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each row's ``tokens`` logit lies below the row's best."""
    return logits.max(-1).values - logits.gather(-1, tokens[:, None])[:, 0]


def summary(gaps: list) -> dict:
    """The numbers a cell may compare, over every compared token: the
    widest gap, the mean gap, and the share of tokens that were not the
    reference's first choice."""
    g = torch.cat(gaps) if gaps else torch.zeros(0)
    n = int(g.numel())
    return {"logit_gap_max": float(g.max()) if n else 0.0,
            "logit_gap_mean": float(g.mean()) if n else 0.0,
            "mismatch_share": float((g > 0).float().mean()) if n else 0.0,
            "compared_tokens": n}


def readings(ref, params, model: dict, picks: list, device,
             control: bool = False) -> dict:
    """The served tokens' gaps under the float32 reference; with
    ``control``, also the gaps of the tokens that the float8 reference
    puts first at the same positions (``control.py``)."""
    served, low = [], []
    with torch.no_grad():
        for seq, at, tokens in sequences(picks, device):
            lg = ref.logits(params, model, seq, at, "f32")
            served.append(gap_of(lg, tokens).cpu())
            if control:
                fp8 = ref.logits(params, model, seq, at, "fp8")
                low.append(gap_of(lg, fp8.argmax(-1)).cpu())
                del fp8
            del lg
    out = {"program": summary(served),
           "worst": worst(picks, served, low if control else None)}
    if control:
        out["control"] = summary(low)
    return out


def worst(picks: list, gaps: list, control: list | None, top: int = 6
          ) -> list:
    """The widest gaps of the served tokens, widest first, each as
    [request index, prompt length, served tokens, index of the token, the
    tick that served it, gap, the control's gap there (or None)]: where in
    the requests the program strayed furthest."""
    rows = []
    for n, (r, g) in enumerate(zip(picks, gaps)):
        for i, x in enumerate(g.tolist()):
            if x > 0:
                rows.append([r.item.index, len(r.item.prompt),
                             len(r.req.tokens), i, r.token_ticks[i]
                             if i < len(r.token_ticks) else None, float(x),
                             float(control[n][i]) if control else None])
    return sorted(rows, key=lambda row: -row[5])[:top]


def complete(records: list) -> int:
    """Finished requests that served other than the tokens they asked
    for."""
    return sum(1 for r in records if r.done and not r.error
               and len(r.req.tokens) != r.item.max_new)


# the counts that must reach their limit; every other number stays under it
AT_LEAST = ("compared_requests", "compared_tokens")


def checks(records: list, picks: list, read: dict, limits: dict) -> dict:
    """The numbers compared, each beside its limit (in the order printed):
    the numbers ``limits`` names, of ``read`` (the program's summary or
    the control's), then the served lengths and the counts of requests
    and tokens compared."""
    out = {name: {"value": read[name], "limit": lim["limit"]}
           for name, lim in limits.items()}
    out["wrong_lengths"] = {"value": complete(records), "limit": 0}
    out["compared_requests"] = {"value": len(picks), "limit": MIN_REQUESTS}
    out["compared_tokens"] = {"value": read["compared_tokens"],
                              "limit": MIN_COMPARED}
    return out


def passed(ch: dict) -> bool:
    return all(c["value"] >= c["limit"] if name in AT_LEAST
               else c["value"] <= c["limit"] for name, c in ch.items())
