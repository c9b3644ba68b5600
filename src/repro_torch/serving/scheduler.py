"""Request scheduler = the Cascade dispatcher applied to serving (§3.3, §3.5).

(Copied from the JAX package's ``serving/scheduler.py``, zlib affinity
hash included, so both packages pick the same requests in the same order.)

Requests are objects put to the engine's request pool; the scheduler is the
dispatcher's policy layer: ROUND_ROBIN spreads requests across engine
replicas (load balancing), FIFO pins a session key (e.g. one chat session /
one camera) to a single replica so its turns stay ordered — the same two
policies, verbatim, as the paper's upcall dispatch.  (In the multi-tenant
``ServeNode`` each replica engine runs its own single-replica scheduler and
replica selection happens one level up, at the store's trigger-put member
pick; ``pending`` feeds the deployment's bounded-admission queue depth.)

A completed ``Request`` carries per-token scores — log p(token) and
next-token entropy, surfaced by the engine's in-dispatch sampler — which
cascade gates (``serving.cluster.CascadeRoute``) read to decide light→heavy
escalation.

Out-of-order issue queue (SLO classes, deadline-derived priority)
-----------------------------------------------------------------
Waiting requests form an ISSUE QUEUE in the style of an out-of-order core:
each entry waits with readiness predicates — a free KV slot, its worst-case
block footprint within the pool's admissible budget, a token-budget lane
(the engine calls ``admit_one`` only while lanes remain), a draft stream if
any (drafts ride ON the request, so they are ready by construction) — and
any READY entry may issue into the tick.  Issue order among ready entries is
earliest-virtual-deadline-first (EDF): a request's virtual deadline is
``arrived_s + deadline_s`` when it carries an explicit deadline, else
``arrived_s +`` its SLO class's default latency target
(``SLO_TARGETS``: ``interactive`` ≪ ``batch``).  Priority aging is intrinsic
— virtual deadlines are ABSOLUTE, so a parked batch request eventually has
an earlier deadline than any fresh interactive arrival and batch can never
starve: the wait behind newer interactive traffic is bounded by the gap
between the class targets.  With a uniform class and no explicit deadlines
EDF degenerates to exact arrival-order FIFO, so single-class workloads
behave precisely as the head-of-line scheduler did.

Per-session ordering stays EXACT and free: FIFO affinity already pins a
session to one replica, and within a replica only the OLDEST waiting entry
of each session is eligible to issue (younger turns of the same session are
held back), so cross-session reordering — the only reordering EDF performs —
can never reorder a conversation.  A too-big head therefore still blocks its
OWN session, but no longer blocks everyone else's.

An entry whose demand exceeds ``max_blocks`` — the pool's ABSOLUTE capacity,
never attainable even fully drained — is issued anyway so the engine's
admission validation can reject it via the completion path; without that
escape hatch it would sit in the queue forever.

Admission: the dense engine admits in batches (``admit``): an optional
`prefill_budget` bounds how many prefills are spliced per decode step so
long prompts cannot starve decodes — the paper's "latency floor under load"
discipline applied to token serving.  ``admit`` sweeps nothing itself but
SKIPS deadline-expired entries (they stay queued for ``pop_expired``), so a
dead head never consumes a free slot or a prefill-budget lane.  The paged
engine's unified token-budget tick admits one entry at a time (``admit_one``)
while it packs the tick's token budget: each admission interleaves with the
engine's begin/pack/commit, so the per-TOKEN budget — not a per-request
count — is what bounds prefill work per tick, and block accounting is
re-read between admissions.

Token-budget arithmetic with speculative decoding: a decode row is NOT
always one token — a speculative row feeds 1 + k tokens (its last committed
token plus k verified drafts).  The engine grants draft lanes LAST, after
every live row's mandatory lane and all prefill chunk packing
(engine._plan_drafts), so the budget remainder ``admit_one`` packs prefill
chunks into is exactly what a non-speculative tick would offer and can
never be oversubscribed by a k-token row.
"""
from __future__ import annotations

import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.core.pools import DispatchPolicy

# SLO classes: default latency targets (seconds) from which a request's
# virtual deadline is derived when it carries no explicit ``deadline_s``.
# The interactive/batch GAP is the aging bound: a queued batch request is
# passed over by newer interactive arrivals for at most
# (batch target - interactive target) before its absolute virtual deadline
# becomes the earliest in the queue.
SLO_INTERACTIVE = "interactive"
SLO_BATCH = "batch"
SLO_TARGETS: dict[str, float] = {SLO_INTERACTIVE: 0.25, SLO_BATCH: 4.0}


def virtual_deadline(req: "Request") -> float:
    """Absolute EDF priority (smaller = sooner): explicit deadline when the
    request carries one, else the SLO class's default latency target."""
    if req.deadline_s is not None:
        return req.arrived_s + req.deadline_s
    return req.arrived_s + SLO_TARGETS.get(req.slo, SLO_TARGETS[SLO_BATCH])


@dataclass
class Request:
    request_id: str
    session_key: str
    prompt: Any                     # token array (1, S) or embeds (1, S, d)
    max_new_tokens: int = 16
    # latency budget, seconds RELATIVE to arrived_s (None = no deadline).
    # Enforced at engine admission, per tick (engine._sweep_deadlines), and
    # at the CascadeRoute boundary: an expired request completes with a
    # structured {"error": "deadline_exceeded", ...} — never a hang.
    deadline_s: float | None = None
    # SLO class ("interactive" | "batch"): sets the default latency target
    # the issue queue derives this request's virtual deadline from when no
    # explicit deadline_s is given, and marks it for the per-class
    # queue-wait histograms.  Interactive requests issue ahead of batch
    # ones under pressure (and, on a preempting engine, may evict a batch
    # victim's KV to the spill pool); absolute virtual deadlines age batch
    # entries so they can never starve.
    slo: str = SLO_BATCH
    # optional draft stream for speculative decoding: token i is a guess for
    # generated token i (e.g. a CascadeRoute plants the LIGHT deployment's
    # generation here when escalating to heavy, so the heavy engine verifies
    # the light tokens k at a time instead of re-deriving them one per tick)
    draft_tokens: Any = None
    arrived_s: float = field(default_factory=time.monotonic)
    # engine-filled:
    slot: int | None = None
    tokens: list[int] = field(default_factory=list)
    # failover/preemption replay: how many leading entries of ``tokens``
    # were folded into ``prompt`` for replay-prefill (on a sibling replica,
    # or on re-issue after a preemption whose spilled KV was lost).  Block/
    # write accounting subtracts it (the folded tokens were going to be
    # written as decode feedbacks anyway), and completion caches only
    # ``tokens[replay_offset:]`` as generated — so a replayed request's
    # allocator footprint is exactly the uninterrupted request's.
    replay_offset: int = 0
    # when the request first issued into an engine (slot granted); queue
    # wait = issued_s - arrived_s feeds the per-SLO-class histograms
    issued_s: float | None = None
    # per-token scores, surfaced from the SAME in-dispatch sampler that
    # picked the token (no extra device→host traffic): log p(token) under
    # the model, and the full next-token distribution's entropy.  Cascade
    # gates (escalate-to-heavy decisions) read these.
    scores: list[float] = field(default_factory=list)      # log p(tok_i)
    entropies: list[float] = field(default_factory=list)   # H(p_i), nats
    first_token_s: float | None = None
    done_s: float | None = None
    # engine rejections set a string; admission sheds set a structured dict
    # ({"error": "shed_overload", "replica": ..., "depth": ..., ...})
    error: str | dict | None = None

    def mean_logprob(self) -> float:
        """Mean per-token log-likelihood of the generation — the CascadeServe
        confidence signal (low = the light model is guessing)."""
        return (sum(self.scores) / len(self.scores)) if self.scores \
            else float("-inf")

    def mean_entropy(self) -> float:
        """Mean next-token distribution entropy (high = uncertain)."""
        return (sum(self.entropies) / len(self.entropies)) if self.entropies \
            else float("inf")

    # ------------------------------------------------------------ deadlines
    def elapsed(self, now: float | None = None) -> float:
        return (time.monotonic() if now is None else now) - self.arrived_s

    def expired(self, now: float | None = None) -> bool:
        return (self.deadline_s is not None
                and self.elapsed(now) > self.deadline_s)

    def remaining(self, now: float | None = None) -> float | None:
        """Budget left, or None when the request carries no deadline."""
        if self.deadline_s is None:
            return None
        return self.deadline_s - self.elapsed(now)

    # --------------------------------------------------------------- replay
    def fold_for_replay(self) -> bool:
        """Fold the not-yet-folded emissions into the prompt so a replay
        PREFILLS them and decode resumes the stream exactly (greedy decoding
        stays bit-identical to the uninterrupted run).  Used by deployment
        failover when a dead replica's KV could not migrate, and by the
        preemption resume path when the spill pool no longer holds the
        parked KV.  False for embeds prompts with emissions — tokens can't
        concatenate onto an embedding matrix, so those can't be replayed."""
        new = self.tokens[self.replay_offset:]
        if not new:
            return True
        p = np.asarray(self.prompt)
        if not np.issubdtype(p.dtype, np.integer):
            return False
        self.prompt = np.concatenate([p, np.asarray(new, p.dtype)])
        self.replay_offset = len(self.tokens)
        return True


class Scheduler:
    def __init__(self, *, policy: DispatchPolicy = DispatchPolicy.ROUND_ROBIN,
                 n_replicas: int = 1, prefill_budget: int = 2) -> None:
        self.policy = policy
        self.n_replicas = n_replicas
        self.prefill_budget = prefill_budget
        # Arrival order is the queue's PHYSICAL order (appends at the tail;
        # ``requeue`` restores an un-placed head).  Issue order is computed
        # per call by the EDF scan — the deque is never resorted, so
        # ``pop_expired``/``drain`` keep their exact in-place semantics
        # under concurrent submits.
        self.waiting: list[deque[Request]] = [deque() for _ in range(n_replicas)]
        self._rr = 0

    def submit(self, req: Request) -> int:
        """Route a request to a replica per the dispatch policy."""
        if self.policy is DispatchPolicy.FIFO:
            r = zlib.crc32(req.session_key.encode()) % self.n_replicas
        else:
            r = self._rr % self.n_replicas
            self._rr += 1
        self.waiting[r].append(req)
        return r

    # ------------------------------------------------------------ issue scan
    def _issue_scan(self, replica: int, *, free_blocks: int | None = None,
                    block_cost: Any = None, max_blocks: int | None = None,
                    now: float | None = None) -> tuple[int, Request] | None:
        """The issue-queue scan: over the arrival-ordered deque, find the
        READY entry with the earliest virtual deadline.

        Eligibility per entry:
        - session-ordered: only the FIRST (oldest) waiting entry of each
          session may issue — younger turns are invisible to the scan, so
          per-session FIFO is exact;
        - not deadline-expired (expired entries stay queued for
          ``pop_expired`` — a dead head must not consume a slot or lane);
        - ready: worst-case block footprint within ``free_blocks`` — except
          an entry whose demand exceeds ``max_blocks`` (never servable),
          which is issued anyway for the engine's rejection path.

        Ties on the virtual deadline resolve to queue position (arrival
        order; a requeued head sits at position 0), keeping single-class
        traffic exactly FIFO.  Returns (index, request) or None.  O(pending)
        per issue — pending is watermark-bounded in deployments, and the
        scan is pure host-side bookkeeping off the dispatch path."""
        q = self.waiting[replica]
        if not q:
            return None
        now = time.monotonic() if now is None else now
        best: tuple[float, int, Request] | None = None
        seen_sessions: set[str] = set()
        for i in range(len(q)):          # index scan: appends may race
            try:
                req = q[i]
            except IndexError:           # concurrent pop shrank the deque
                break
            if req.session_key in seen_sessions:
                continue
            seen_sessions.add(req.session_key)
            if req.expired(now):
                continue
            if free_blocks is not None and block_cost is not None:
                need = block_cost(req)
                if ((max_blocks is None or need <= max_blocks)
                        and need > free_blocks):
                    continue             # waits on blocks; others may issue
            vdl = virtual_deadline(req)
            if best is None or vdl < best[0]:
                best = (vdl, i, req)
        if best is None:
            return None
        return best[1], best[2]

    def _pop_at(self, replica: int, index: int, req: Request) -> Request:
        """Remove the scanned entry; ``del q[i]`` is atomic under the GIL
        and concurrent submits only append past it."""
        q = self.waiting[replica]
        try:
            if q[index] is req:
                del q[index]
                return req
        except IndexError:
            pass
        q.remove(req)                    # a concurrent pop shifted it
        return req

    def admit(self, replica: int, free_slots: int) -> list[Request]:
        """Batch admission (dense engines), bounded by free slots and the
        per-tick prefill budget: repeated issue-queue picks, so the batch
        comes out in priority order with expired entries skipped."""
        out: list[Request] = []
        now = time.monotonic()
        while len(out) < min(free_slots, self.prefill_budget):
            got = self._issue_scan(replica, now=now)
            if got is None:
                break
            out.append(self._pop_at(replica, *got))
        return out

    def admit_one(self, replica: int, *, free_slots: int,
                  free_blocks: int | None = None, block_cost: Any = None,
                  max_blocks: int | None = None) -> Request | None:
        """Issue ONE ready request (earliest virtual deadline), or None when
        nothing is ready.  The paged engine's unified tick calls this in a
        loop while packing its token budget, so block accounting is re-read
        between admissions (each ``begin`` changes what is available)."""
        if free_slots <= 0:
            return None
        got = self._issue_scan(replica, free_blocks=free_blocks,
                               block_cost=block_cost, max_blocks=max_blocks)
        if got is None:
            return None
        return self._pop_at(replica, *got)

    def best_waiting(self, replica: int) -> Request | None:
        """The entry the NEXT issue would pick if resources were infinite —
        the engine's preemption pressure signal: when this request exists
        but cannot issue for lack of slots/blocks, and some in-flight
        request has a strictly later virtual deadline, the engine may spill
        that victim.  Read-only (nothing is popped)."""
        got = self._issue_scan(replica)
        return None if got is None else got[1]

    def requeue(self, replica: int, req: Request) -> None:
        """Return an admitted-but-unplaced (or preempted) request to the
        HEAD of its queue: it becomes the oldest waiting entry of its
        session again, so per-session order is preserved (callers that
        requeue a contiguous admitted run do so in reverse)."""
        self.waiting[replica].appendleft(req)

    def pop_expired(self, replica: int, now: float | None = None
                    ) -> list[Request]:
        """Remove and return every queued request whose deadline has passed.

        Pop-rotates IN PLACE (pop each element once, append keepers back)
        rather than rebuilding the deque: an upcall thread may be appending
        concurrently, and a replacement deque would silently drop its
        arrival.  Relative order of the keepers is preserved."""
        q = self.waiting[replica]
        now = time.monotonic() if now is None else now
        expired: list[Request] = []
        for _ in range(len(q)):
            req = q.popleft()
            (expired if req.expired(now) else q).append(req)
        return expired

    def drain(self, replica: int) -> list[Request]:
        """Pop every queued request (replica evacuation on mark-down).
        Same in-place pop discipline as ``pop_expired``: a concurrent
        submit's append is either drained or survives for the sweep."""
        q = self.waiting[replica]
        out: list[Request] = []
        for _ in range(len(q)):
            out.append(q.popleft())
        return out

    def pending(self, replica: int) -> int:
        return len(self.waiting[replica])
