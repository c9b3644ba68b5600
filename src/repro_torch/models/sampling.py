"""In-dispatch samplers: plain sampling-with-scores and speculative verify
(port of the JAX package's ``models/sampling.py``).

Both return token ids plus per-token ``[log p(token), entropy]`` scores from
the same log-softmax, so the host never sees logits.

``speculative_verify`` is the acceptance rule of speculative decoding with
point-mass drafts: accept draft ``d_i`` with probability ``p_target(d_i)``;
at the first rejection sample the residual (the target with ``d_i`` masked
out, renormalised); when every draft is accepted, sample one bonus token.
Greedy (``temperature <= 0``) accepts while the draft is the argmax and
emits the argmax at the first mismatch, so the stream is identical to plain
greedy decoding.  ``torch.argmax`` takes the first maximum, as
``jnp.argmax`` does.

Sampling draws from a ``torch.Generator`` seeded with the dispatch's seed
(Gumbel-max for categorical draws).  The JAX and torch generators differ,
so sampled streams match the reference in distribution only.  ``seed`` is
an int, from which a fresh generator is made, or a generator the caller has
just seeded with ``manual_seed``, which draws the same numbers: the engine
reseeds one generator per dispatch, which a CUDA graph can hold (it reads
the generator's seed and offset at each replay).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _generator(seed: int | torch.Generator, device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def _categorical(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``logits`` (last axis) by Gumbel-max."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _scores(logp: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per-token [log p(token), entropy(p)] from an UNTEMPERED log-softmax."""
    tok_logp = torch.gather(logp, -1, tokens[..., None].long())[..., 0]
    ent = -torch.sum(torch.exp(logp) * logp, dim=-1)
    return torch.stack([tok_logp, ent], dim=-1)


def sample_with_scores(logits: torch.Tensor, seed: int | torch.Generator,
                       temperature: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample + score one token per row.  logits (B, V); returns
    (tokens (B,) int32, scores (B, 2))."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if temperature <= 0:
        tok = torch.argmax(logits, dim=-1)
    else:
        tok = _categorical(_generator(seed, logits.device),
                           logits.float() / temperature)
    tok = tok.to(torch.int32)
    return tok, _scores(logp, tok)


def speculative_verify(logits: torch.Tensor, draft_tokens: torch.Tensor,
                       draft_len: torch.Tensor, seed: int | torch.Generator,
                       temperature: float
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rejection-sampling acceptance over a row's verified draft positions.

    logits (R, K+1, V): row r's target logits at its fed positions; draft
    tokens (R, K) int32 (garbage past ``draft_len``); draft_len (R,) int32
    in [0, K].  Returns tokens (R, K+1) int32 (emitted token j of row r is
    ``tokens[r, j]`` for j <= n_accept[r]), n_accept (R,) int32 and scores
    (R, K+1, 2).  Rows with ``draft_len == 0`` reduce to
    ``sample_with_scores`` on their position-0 logits."""
    R, K1, V = logits.shape
    K = K1 - 1
    dev = logits.device
    lf = logits.float()
    logp = torch.log_softmax(lf, dim=-1)
    idx = torch.arange(K1, dtype=torch.int32, device=dev)[None, :]
    live = idx[:, :K] < draft_len[:, None]                     # (R, K)
    drafts = draft_tokens.long()
    if temperature <= 0:
        cand = torch.argmax(logits, dim=-1).to(torch.int32)    # (R, K+1)
        acc = (draft_tokens == cand[:, :K]) & live
    else:
        gen = _generator(seed, dev)
        tl = lf / temperature
        if K > 0:
            p = torch.softmax(tl[:, :K, :], dim=-1)
            pd = torch.gather(p, -1, drafts[..., None])[..., 0]
            u = torch.rand((R, K), generator=gen, device=dev)
            acc = (u < pd) & live
            dmask = torch.zeros((R, K, V), dtype=torch.bool, device=dev)
            dmask.scatter_(-1, drafts[..., None], live[..., None])
            tl = tl.clone()
            tl[:, :K, :] = torch.where(dmask, torch.full_like(dmask, NEG_INF,
                                                              dtype=tl.dtype),
                                       tl[:, :K, :])
        else:
            acc = torch.zeros((R, 0), dtype=torch.bool, device=dev)
        cand = _categorical(gen, tl).to(torch.int32)
    if K > 0:
        n_accept = torch.sum(torch.cumprod(acc.to(torch.int32), dim=1), dim=1)
        drafts_pad = torch.cat(
            [draft_tokens.to(torch.int32),
             torch.zeros((R, 1), dtype=torch.int32, device=dev)], dim=1)
        tokens = torch.where(idx < n_accept[:, None], drafts_pad, cand)
    else:
        n_accept = torch.zeros((R,), dtype=torch.int32, device=dev)
        tokens = cand
    return tokens, n_accept.to(torch.int32), _scores(logp, tokens)
