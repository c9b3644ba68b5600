"""Draft sources for speculative decoding on the unified tick.

(Copied from the JAX package's ``serving/draft.py``: pure host logic.)

A ``DraftSource`` proposes up to k candidate next tokens for a decode row;
the engine packs them behind the row's last committed token so the target
model VERIFIES all of them in the one existing ragged dispatch, and the
in-dispatch acceptance rule (models.sampling.speculative_verify) keeps the
longest target-confirmed prefix.  Drafting is pure host-side bookkeeping —
no extra model dispatch, no extra device→host sync — so a draft source must
be cheap: it runs on the tick's critical path once per live decode row.

Two sources ship, composed by default:

``RequestDraftSource`` — the cascade drafter (CascadeServe's "light work is
    never wasted"): a request escalated light→heavy carries the LIGHT
    deployment's generation in ``Request.draft_tokens``, and the heavy
    model verifies those tokens k at a time instead of re-deriving them one
    tick each.  Drafts are proposed only while the heavy generation is
    still on-script (its tokens so far equal the draft prefix) — once it
    diverges the light answer is no longer predictive and lanes are better
    spent elsewhere.

``NgramDraftSource`` — self-drafting (prompt-lookup decoding): match the
    trailing n-gram of prompt+generated against earlier occurrences in the
    same history and propose the continuation after the most recent match.
    Free lunch on repetitive text (quotes, code, structured output);
    harmless elsewhere (unaccepted drafts cost only spare budget lanes the
    acceptance rule rejects in-dispatch).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .scheduler import Request

# Lazily-built request history (prompt + generated tokens): the engine hands
# sources a zero-arg provider instead of the array itself, so a source that
# never looks at history (RequestDraftSource — the cascade path) costs no
# O(S + generated) concatenation per row per tick.
HistoryFn = Callable[[], np.ndarray]


class DraftSource:
    """Proposes up to ``k`` draft tokens continuing the request."""

    def propose(self, req: Request, history: HistoryFn, k: int) -> list[int]:
        """``history()`` returns the request's prompt + generated tokens
        (the last entry is the token about to be fed) — call it only if
        needed; it is built on first call.  Return 0..k int tokens that
        guess the continuation.  Fewer than k is fine; an empty list means
        "no guess" and the row decodes plainly this tick."""
        raise NotImplementedError


class NgramDraftSource(DraftSource):
    """Self-drafting from the request's own history (prompt lookup).
    ``max_history`` bounds the per-tick scan (and the match window) so
    drafting stays O(max_history), not O(prompt + generated), on the
    tick's critical path."""

    def __init__(self, n: int = 3, max_history: int = 2048) -> None:
        if n < 1:
            raise ValueError("n-gram order must be >= 1")
        self.n = n
        self.max_history = max_history

    def propose(self, req: Request, history: HistoryFn, k: int) -> list[int]:
        h = np.asarray(history())
        if self.max_history is not None:
            h = h[-self.max_history:]
        L = len(h)
        n = self.n
        if k <= 0 or L <= n:
            return []
        suffix = h[L - n:]
        windows = np.lib.stride_tricks.sliding_window_view(h, n)
        matches = np.flatnonzero((windows == suffix).all(axis=1))
        matches = matches[matches < L - n]          # drop the trivial self-match
        if len(matches) == 0:
            return []
        i = int(matches[-1])                        # most recent occurrence
        return [int(t) for t in h[i + n:i + n + k]]


class RequestDraftSource(DraftSource):
    """Drafts carried BY the request (``Request.draft_tokens``): token i of
    the draft is the guess for generated token i.  Proposed only while the
    generation is on-script (generated tokens == draft prefix).  Never
    touches ``history`` — the cascade fast path does no per-tick copies."""

    def propose(self, req: Request, history: HistoryFn, k: int) -> list[int]:
        d = req.draft_tokens
        if d is None or k <= 0:
            return []
        d = np.asarray(d)
        g = len(req.tokens)
        if g == 0 or g >= len(d):
            return []
        if not np.array_equal(np.asarray(req.tokens, dtype=np.int64),
                              np.asarray(d[:g], dtype=np.int64)):
            return []
        return [int(t) for t in d[g:g + k]]


class ChainDraftSource(DraftSource):
    """First source that yields tokens wins."""

    def __init__(self, sources: list[DraftSource]) -> None:
        self.sources = list(sources)

    def propose(self, req: Request, history: HistoryFn, k: int) -> list[int]:
        for s in self.sources:
            out = s.propose(req, history, k)
            if out:
                return out
        return []


def default_draft_source() -> DraftSource:
    """Engine default: request-carried drafts (the cascade path) first,
    n-gram self-drafting as the fallback."""
    return ChainDraftSource([RequestDraftSource(), NgramDraftSource()])
