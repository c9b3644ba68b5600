"""Multi-tenant serving on the Cascade fast path (§2, §3.3, §3.5).

Port of the JAX package's ``serving/cluster.py``.  A ``ServeNode`` owns one
device (``device``, the card by default) and its KV ``DeviceStore``; every
deployment's params must already live there, and its replicas share that
one param tree.  Each replica engine keeps its own captured ticks: a CUDA
graph holds its own engine's pool and staging pointers, so a node holds one
captured graph per replica and tick kind, where the JAX package shares one
compiled program across a deployment's replicas.  With
``devices_per_replica`` each replica gets its own disjoint mesh slice of
the node's logical devices (``launch.mesh.local_devices``), its params and
pool placed over it and its tick tensor-parallel.  The
upcall threads' paths (admission, submit, rejection, completion) touch no
device, so requests may arrive while the tick thread captures a tick.

Cascade's thesis is that ONE platform hosts many collocated ML services with
per-event latency guarantees.  This module is that thesis applied to LM
serving, split into two layers:

``ServeNode``
    One Cascade node-group: the shared ``Worker`` set (one upcall thread per
    worker, so FIFO sessions stay ordered), the ``CascadeStore`` they form,
    and a single KV ``DeviceStore`` every paged deployment's block pools
    live on.  The node's tick loop ticks every busy engine across ALL
    deployments — a paged attention model and a dense SSM model run side by
    side on the same workers, each keeping its own host-sync invariant
    (paged: ``host_syncs == ticks``; dense: ``host_syncs == decode_ticks +
    prefill_batches``).

``ModelDeployment``
    One hosted model: a replica set of ``ServeEngine``s registered as
    lambdas on ``/serve/<model>/req``, responses ``put`` into
    ``/serve/<model>/out``, paged KV pools under
    ``/kv/<model>/replica<r>/pool`` on the node's device store.  Replica
    selection is the store's trigger-put member pick (ROUND_ROBIN spreads
    load; FIFO routes by ``affinity_shard_hash`` over the session prefix so
    a session's turns stay on one replica, in order).  ``stop()`` tears the
    deployment down: lambdas unregistered, req/out pools removed from the
    store, KV pools dropped from the device store.

Bounded admission (MultiTASC++-style shed/redirect)
---------------------------------------------------
A deployment constructed with a ``watermark`` bounds each replica's queue:
the serving lambda measures its replica's depth — engine backlog (queued +
mid-prefill + decoding) plus the worker's outstanding upcall events (the
dispatcher's per-queue depth introspection) — and an over-watermark arrival
is REDIRECTED to the least-loaded sibling replica still under the
watermark, or, when every sibling is saturated, SHED with a structured
``/error`` reason (never silently dropped: the client sees exactly why).
Continuous shed/redirect keeps tail latency flat under overload instead of
letting queues grow without bound; ``stats()`` reports both counters.
Redirect trades FIFO session affinity for boundedness — exactly the
MultiTASC++ trade.

Cascade escalation (CascadeServe-style light→heavy routing)
-----------------------------------------------------------
``CascadeRoute(light, heavy, gate)`` submits every request to the LIGHT
deployment first.  When the gate trips — mean decode logprob below (or mean
next-token entropy above) a threshold, computed from the per-token scores
the engine's in-dispatch sampler already has on device — the request is
escalated via an internal ``trigger_put`` into the HEAVY deployment's req
pool: the request moves to the heavy weights, the weights never move (§2
data/compute collocation).  Confident light answers never touch the heavy
model, which is what puts cascaded serving ahead of single-model serving on
the latency/throughput frontier.  The escalated request carries the light
generation as a DRAFT stream (``draft_from_light``): a speculative heavy
deployment (``spec_k > 0``) verifies the light tokens k at a time in its
one ragged dispatch — the self-drafting cascade, where the light model
doubles as the heavy model's draft model and its work is never wasted.
"""
from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from repro_torch.core.devstore import DeviceStore, resolve_device
from repro_torch.core.dispatcher import LambdaHandle
from repro_torch.core.objects import CascadeObject
from repro_torch.core.pools import (DispatchPolicy, Persistence, PoolSpec,
                                    affinity_shard_hash)
from repro_torch.core.store import CascadeStore, SpillPool, Worker
from repro_torch.launch.mesh import local_devices, mesh_slices
from repro_torch.models import supports_paged
from repro_torch.models.config import ModelConfig

from .engine import ServeEngine
from .faults import InjectedFault, ReplicaCrashed
from .scheduler import Request, Scheduler, virtual_deadline

# key = /serve/<model>/req/<session>/<request_id> → 5 components; hashing the
# first 4 ("serve", model, "req", session) gives per-session affinity.
_SESSION_DEPTH = 4


class ModelDeployment:
    """One model hosted on a ``ServeNode``: engines, pools, admission.

    Created through ``ServeNode.deploy`` — replica ``r`` lives on node
    worker ``r``, its lambda registered on ``/serve/<name>/req``, its paged
    KV pool (pure-attention models) on the node's shared device store under
    ``/kv/<name>/replica<r>/pool``.  FIFO session affinity makes the
    per-replica prefix trie pay: every turn of a session lands where its
    prefix blocks already sit.
    """

    def __init__(self, node: "ServeNode", name: str, cfg: ModelConfig,
                 params, *, n_replicas: int, n_slots: int, max_len: int,
                 policy: DispatchPolicy, temperature: float,
                 paged: bool | None, block_size: int,
                 num_blocks: int | None, prefix_cache: bool,
                 token_budget: int | None, watermark: int | None,
                 seed_base: int, spec_k: int = 0,
                 watchdog_s: float | None = None, retry_budget: int = 2,
                 retry_backoff_s: float = 0.002, preempt: bool = False,
                 spill_capacity_blocks: int = 256,
                 kv_dtype: str | None = None,
                 devices_per_replica: int | None = None) -> None:
        if n_replicas > len(node.workers):
            raise ValueError(
                f"deployment {name!r} wants {n_replicas} replicas but the "
                f"node has {len(node.workers)} workers")
        self.node = node
        self.name = name
        self.cfg = cfg
        self.policy = policy
        self.watermark = watermark
        self.req_prefix = f"/serve/{name}/req"
        self.out_prefix = f"/serve/{name}/out"
        self.paged = supports_paged(cfg) if paged is None else paged
        if spec_k and not self.paged:
            raise ValueError(
                f"deployment {name!r}: spec_k={spec_k} needs the paged path "
                f"(speculative verify rows + KV rollback; see "
                f"models.supports_speculative)")
        self.worker_ids = list(range(n_replicas))
        session_hash = functools.partial(affinity_shard_hash,
                                         depth=_SESSION_DEPTH)
        node.store.create_pool(PoolSpec(
            path=self.req_prefix, persistence=Persistence.TRANSIENT,
            replication=n_replicas, dispatch=policy,
            shard_hash=session_hash), worker_ids=self.worker_ids)
        node.store.create_pool(PoolSpec(path=self.out_prefix, replication=1))
        # Preemption (opt-in, paged only): ONE deployment-wide spill pool,
        # store-backed under /spill/<name>, shared by every replica engine —
        # so a session preempted on replica A whose replica later dies can
        # still be unparked by the sibling its re-homed request lands on.
        # Engines park/unpark on the tick thread only (tick + mark_down),
        # so the shared instance needs no lock.
        self.preempt = bool(preempt)
        if self.preempt and not self.paged:
            raise ValueError(f"deployment {name!r}: preemption needs the "
                             f"paged path (KV blocks to spill)")
        self.spill_pool: SpillPool | None = None
        self.spill_prefix = f"/spill/{name}"
        if self.preempt:
            node.store.create_pool(PoolSpec(path=self.spill_prefix,
                                            replication=1))
            self.spill_pool = SpillPool(
                capacity_blocks=spill_capacity_blocks, store=node.store,
                prefix=self.spill_prefix)
        # Mesh slices (devices_per_replica=d): the node carves d logical
        # devices per replica out of its free list — DISJOINT slices, so
        # sibling replicas never contend for one — and each engine places
        # its params and paged KV pool over its own slice (launch.sharding
        # rules); stop() gives the devices back.
        self.meshes: list[Any] = []
        if devices_per_replica is not None:
            if not self.paged:
                raise ValueError(
                    f"deployment {name!r}: mesh slices shard the paged KV "
                    f"pool; the dense path is single-device only")
            self.meshes = node.take_device_slices(n_replicas,
                                                  devices_per_replica)
        self.engines: list[ServeEngine] = []
        for r in range(n_replicas):
            kw: dict[str, Any] = dict(paged=self.paged)
            if self.paged:
                kw.update(block_size=block_size, num_blocks=num_blocks,
                          prefix_cache=prefix_cache,
                          devstore=node.kv_store(),
                          kv_key=f"/kv/{name}/replica{r}/pool",
                          kv_dtype=kv_dtype,
                          token_budget=token_budget, spec_k=spec_k,
                          spill_pool=self.spill_pool, preempt=self.preempt)
                if self.meshes:
                    kw["mesh"] = self.meshes[r]
            # every replica shares the one param tree; each keeps its own
            # captured ticks (a graph holds its engine's pool and staging
            # pointers, so graphs cannot be shared as jitted programs are)
            self.engines.append(ServeEngine(
                cfg, params, n_slots=n_slots, max_len=max_len,
                temperature=temperature, scheduler=Scheduler(n_replicas=1),
                on_complete=self._on_engine_complete,
                seed_offset=seed_base + r, device=node.device, **kw))
        self._handles: list[tuple[LambdaHandle, int]] = []
        for r in range(n_replicas):
            handle = LambdaHandle(
                name=f"{name}-replica-{r}", prefix=self.req_prefix,
                fn=functools.partial(self._on_request, r), dispatch=policy,
                # dispatcher-level mirror of the store's member pick: FIFO
                # queue selection hashes the session prefix, not the full key
                queue_hash=session_hash if policy is DispatchPolicy.FIFO
                else None)
            node.store.register_lambda(handle, worker_ids=[self.worker_ids[r]])
            self._handles.append((handle, self.worker_ids[r]))
        # request_id → replica index, for introspection/tests; bounded so a
        # long-running deployment doesn't grow it without limit.
        self.routed: dict[str, int] = {}
        self._routed_cap = 4096
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.shed = 0            # over-watermark arrivals refused outright
        self.redirected = 0      # over-watermark arrivals moved to a sibling
        self.preempt_admits = 0  # over-watermark arrivals admitted anyway
        #                          because the target held a lower-priority
        #                          in-flight victim (preempt-before-shed)
        self.listener_errors = 0  # on_done callbacks that raised (and were
        #                           contained so the completion still landed)
        # ------------------------------------------------- fault tolerance
        # ``down`` maps replica → reason; mark_down (tick thread only)
        # populates it and evacuates.  ``_progress`` backs the per-replica
        # tick watchdog: (stats snapshot, last time it changed) — a BUSY
        # replica whose snapshot freezes for > watchdog_s is wedged (an
        # un-stalled busy engine always advances ticks or prefill tokens).
        self.watchdog_s = watchdog_s
        self.retry_budget = retry_budget
        self.retry_backoff_s = retry_backoff_s
        self.down: dict[int, str] = {}
        self.failovers = 0        # replicas marked down
        self.rehomed = 0          # requests moved off a dead replica
        self.migrated = 0         # ... with their KV spilled + restored
        self.replayed = 0         # ... by folding emissions into the prompt
        self.failover_failed = 0  # ... completed with a replica_failed error
        self.submit_retries = 0   # submits retried on a sibling / backoff
        self._progress: list[tuple[tuple, float]] = [
            ((0, 0, 0), time.monotonic()) for _ in range(n_replicas)]
        # completion listeners (e.g. a CascadeRoute's gate); fired BEFORE the
        # response is put so an escalation's submit is counted before this
        # request's completion — the node can never observe a false drain.
        self.on_done: list[Callable[[Request], None]] = []
        self._stopped = False

    # ---------------------------------------------------------- admission
    def queue_depth(self, replica: int) -> int:
        """This replica's bounded-queue depth: engine backlog (queued +
        mid-prefill + decoding) plus THIS replica lambda's outstanding
        upcall events (the dispatcher's per-handle depth introspection) —
        requests trigger-put to this replica whose serving lambda hasn't
        finished enqueueing them yet.  Filtered per handle so another
        deployment's traffic on the shared worker never trips this
        deployment's watermark."""
        wid = self.worker_ids[replica]
        handle = self._handles[replica][0]
        return (self.engines[replica].backlog()
                + self.node.workers[wid].dispatcher.queue_depth(handle.name))

    def _least_loaded_sibling(self, replica: int) -> int | None:
        """The redirect target: the sibling with the smallest depth still
        under the watermark, or None when every sibling is saturated.

        Depth reads are deliberately lock-free HEURISTICS (MultiTASC++'s
        continuous decisions, not admission-control transactions): a
        sibling mid-lambda is transiently counted in both its upcall depth
        and its engine backlog, and two workers racing the same sibling can
        each redirect to it — so decisions can be off by ±1 per concurrent
        arrival.  The watermark bounds queue GROWTH, which tolerates that
        slack; serializing every admission through a node-wide lock would
        put a mutex on the fast path instead."""
        best, best_depth = None, None
        for r in range(len(self.engines)):
            if r == replica or r in self.down or self.engines[r].crashed:
                continue
            d = self.queue_depth(r)
            if d < self.watermark and (best is None or d < best_depth):
                best, best_depth = r, d
        return best

    def _can_preempt_for(self, req: Request, replica: int) -> bool:
        """Whether admitting ``req`` over the watermark is justified by the
        EDF policy: the target holds some request, in a DIFFERENT session,
        with a strictly later virtual deadline — either IN FLIGHT (the
        engine's tick-entry preemption can spill it to make room) or still
        QUEUED (``req`` will issue ahead of it, so the watermark's wait
        bound on this arrival holds; the later-deadline entry was already
        accepted and merely keeps its place).  A lock-free heuristic read
        over the engine's slot maps and its scheduler's arrival deque
        (``list(deque)`` snapshots atomically under the GIL — same
        discipline as ``_least_loaded_sibling``: the watermark bounds
        growth, so an off-by-one race admits at most one extra request,
        which the next tick's preemption or shed absorbs)."""
        if not self.preempt:
            return False
        eng = self.engines[replica]
        vdl = virtual_deadline(req)
        queued = list(eng.scheduler.waiting[eng.replica_id])
        inflight = [r for m in (eng.prefilling, eng.live)
                    for r in list(m.values())]
        return any(r.session_key != req.session_key
                   and virtual_deadline(r) > vdl
                   for r in inflight + queued)

    def _shed(self, req: Request, replica: int, depth: int) -> None:
        """MultiTASC++-style shed: refuse with a STRUCTURED reason so the
        client can tell overload from a model refusal or a short answer."""
        req.error = {"error": "shed_overload", "deployment": self.name,
                     "replica": replica, "depth": depth,
                     "watermark": self.watermark}
        with self._lock:
            self.shed += 1
        self._complete_request(req)

    # ------------------------------------------------- replica health
    def install_faults(self, injector) -> None:
        """Bind a ``serving.faults.FaultInjector`` to every replica's
        engine seams (tick + submit)."""
        for r, eng in enumerate(self.engines):
            eng.faults = injector.bind(self.name, r)

    def is_down(self, replica: int) -> bool:
        return replica in self.down

    def _failover_target(self, exclude: set[int] | tuple = ()) -> int | None:
        """Least-loaded HEALTHY replica (down/crashed/excluded skipped).
        No watermark here: completing an already-admitted request beats
        boundedness — shedding work the client was promised would turn a
        replica fault into an availability fault."""
        cands = [r for r in range(len(self.engines))
                 if r not in self.down and not self.engines[r].crashed
                 and r not in exclude]
        if not cands:
            return None
        return min(cands, key=self.queue_depth)

    def mark_down(self, replica: int, reason: str) -> None:
        """Take a dead/wedged replica out of service and re-home every
        request it holds.  TICK THREAD ONLY (it touches engine slot
        state); idempotent.  Order matters: the down-flag and the engine's
        ``crashed`` bit are set BEFORE evacuation so a submit racing this
        mark-down raises ``ReplicaCrashed`` and retries on a sibling
        instead of landing in the drained queue (``sweep_down`` catches
        the residual window)."""
        with self._lock:
            if replica in self.down:
                return
            self.down[replica] = reason
            self.failovers += 1
        eng = self.engines[replica]
        eng.crashed = True
        spill = eng.paged and eng.kv_recoverable
        try:
            queued, inflight = eng.evacuate(spill_kv=spill)
        except Exception:
            queued, inflight = [], []
        for req in queued:
            self._re_home(req, None)
        for req, spilled in inflight:
            self._re_home(req, spilled)

    def sweep_down(self) -> None:
        """Tick-thread sweep: re-home any request that slipped into a
        down replica's queue between the submit-side ``crashed`` check and
        the evacuation drain (the mark-down race's residual window)."""
        for r in list(self.down):
            eng = self.engines[r]
            if eng.idle():
                continue
            try:
                queued, inflight = eng.evacuate(spill_kv=False)
            except Exception:
                continue
            for req in queued:
                self._re_home(req, None)
            for req, spilled in inflight:
                self._re_home(req, spilled)

    def check_watchdog(self, now: float | None = None) -> None:
        """Per-replica tick watchdog (tick thread): a BUSY replica whose
        progress snapshot hasn't changed within ``watchdog_s`` is wedged —
        a healthy busy engine always advances ticks, prefill tokens, or
        output tokens every tick-loop pass — and is marked down."""
        if self.watchdog_s is None:
            return
        now = time.monotonic() if now is None else now
        for r, eng in enumerate(self.engines):
            if r in self.down:
                continue
            snap = (eng.stats.ticks, eng.stats.prefill_tokens,
                    eng.stats.tokens_out)
            last, since = self._progress[r]
            if eng.idle() or snap != last:
                self._progress[r] = (snap, now)
            elif now - since > self.watchdog_s:
                self.mark_down(r, "stalled")

    def _fold_for_replay(self, req: Request) -> bool:
        """Replay folding now lives on the request itself
        (``Request.fold_for_replay`` — the preemption resume path needs it
        engine-side too); kept as a thin delegate for callers/tests."""
        return req.fold_for_replay()

    def _re_home(self, req: Request, spilled) -> None:
        """Move one evacuated request to a healthy sibling: KV migration
        (adopt the spilled blocks) when possible, replay otherwise; every
        path terminates — no sibling or no replay means a structured
        ``replica_failed`` completion, never a stranded request."""
        tried: set[int] = set()
        while True:
            target = self._failover_target(tried)
            if target is None:
                self._fail_request(req, "no healthy sibling to re-home onto")
                return
            eng = self.engines[target]
            if spilled is not None and not req.expired() \
                    and eng.adopt(req, spilled):
                with self._lock:
                    self.rehomed += 1
                    self.migrated += 1
                    self.routed[req.request_id] = target
                return
            replay = bool(req.tokens)
            if not self._fold_for_replay(req):
                self._fail_request(
                    req, "session not replayable (embeds prompt) and its "
                         "KV was unrecoverable")
                return
            try:
                eng.submit(req)
            except (ReplicaCrashed, InjectedFault):
                tried.add(target)
                with self._lock:
                    self.submit_retries += 1
                continue
            with self._lock:
                self.rehomed += 1
                if replay:
                    self.replayed += 1
                self.routed[req.request_id] = target
            return

    def _fail_request(self, req: Request, reason: str) -> None:
        """Terminal structured error for a request a fault orphaned: the
        client sees WHY (and keeps any partial tokens) instead of a result
        that never arrives."""
        req.error = {"error": "replica_failed", "deployment": self.name,
                     "reason": reason, "request_id": req.request_id,
                     "generated": len(req.tokens)}
        with self._lock:
            self.failover_failed += 1
        self._complete_request(req)

    # ------------------------------------------------------------- lambdas
    def _on_request(self, replica: int, obj: CascadeObject, _event) -> str:
        """The serving lambda: runs on the replica worker's upcall thread.
        Bounded admission happens HERE, at the door — before the request
        ever reaches an engine queue."""
        comps = obj.key.split("/")
        session, request_id = comps[-2], comps[-1]
        payload = obj.payload
        req = Request(request_id=request_id, session_key=session,
                      prompt=payload["prompt"],
                      max_new_tokens=int(payload.get("max_new_tokens", 16)),
                      draft_tokens=payload.get("draft"),
                      deadline_s=payload.get("deadline_s"))
        if payload.get("slo") is not None:
            req.slo = str(payload["slo"])
        if "t0" in payload:
            # deadline budgets are measured from CLIENT submit time, not
            # from when the upcall got scheduled
            req.arrived_s = payload["t0"]
        target = replica
        if target in self.down or self.engines[target].crashed:
            # arrival aimed at a dead replica (FIFO affinity outlives the
            # replica): re-target to the least-loaded healthy sibling
            t = self._failover_target()
            if t is None:
                self._fail_request(req, self.down.get(target, "crashed"))
                return request_id
            target = t
        if self.watermark is not None:
            # minus one: this very event still counts in the worker's
            # outstanding-upcall depth while we are running it
            depth = self.queue_depth(target) - 1
            if depth >= self.watermark:
                sibling = self._least_loaded_sibling(target)
                if sibling is not None:
                    target = sibling
                    with self._lock:
                        self.redirected += 1
                elif self._can_preempt_for(req, target):
                    # preempt-before-shed: every sibling is saturated, but
                    # the target holds an in-flight request with a strictly
                    # later virtual deadline — admit over the watermark and
                    # let the engine's tick-entry preemption make room by
                    # spilling that victim, instead of refusing work the
                    # EDF policy says should run first.  The overshoot is
                    # bounded: one admission per arrival, one spill per tick.
                    with self._lock:
                        self.preempt_admits += 1
                else:
                    self._shed(req, target, depth)
                    return request_id
        # Bounded retry with capped exponential backoff: a transient
        # injected/real submit failure (or a replica crashing between the
        # health check above and the enqueue) moves the request to the next
        # healthy sibling; exhaustion terminates with a structured error —
        # admission never strands a request.
        tried: set[int] = set()
        delay = self.retry_backoff_s
        for _ in range(self.retry_budget + 1):
            try:
                self.engines[target].submit(req)
            except (ReplicaCrashed, InjectedFault):
                tried.add(target)
                with self._lock:
                    self.submit_retries += 1
                nxt = self._failover_target(tried)
                if nxt is None:
                    break
                target = nxt
                time.sleep(delay)
                delay = min(delay * 2, 0.05)
                continue
            with self._lock:
                self.routed[request_id] = target
                while len(self.routed) > self._routed_cap:
                    self.routed.pop(next(iter(self.routed)))
            return request_id
        self._fail_request(req, "no healthy replica accepted the submit")
        return request_id

    def _on_engine_complete(self, req: Request) -> None:
        self._complete_request(req)

    def _complete_request(self, req: Request) -> None:
        """Completion at the store boundary, shared by engine completions,
        engine rejections, and admission sheds.  A refused request still
        completes — empty tokens at the normal key, and its reason under
        ``<request_id>/error`` so clients can tell refusal from a short
        generation (read it with ``error()``)."""
        req.done_s = req.done_s or time.monotonic()
        if self.spill_pool is not None:
            # terminal state reached outside an engine (shed, failover
            # failure): a preempted request's parked KV must not leak
            self.spill_pool.discard(req.request_id)
        for fn in list(self.on_done):
            try:
                fn(req)
            except Exception:
                # a listener failure (e.g. a cascade escalating into a
                # stopped deployment) must not lose THIS request's answer:
                # the response is still put and the completion still counted
                # (the client sees the un-escalated result), and the drain
                # can still finish.  Counted so operators can see it.
                with self._lock:
                    self.listener_errors += 1
        if req.error is not None:
            self.node.store.put(f"{self.out_prefix}/{req.request_id}/error",
                                req.error)
        self.node.store.put(f"{self.out_prefix}/{req.request_id}",
                            np.asarray(req.tokens, np.int32))
        with self._lock:
            self.completed += 1
        self.node._note_completed()

    # ------------------------------------------------------------- clients
    def submit(self, session_key: str, request_id: str, prompt: Any, *,
               max_new_tokens: int = 16, draft_tokens: Any = None,
               deadline_s: float | None = None, slo: str | None = None):
        """Fire a request into the fast path (trigger_put; nothing stored).
        ``draft_tokens`` rides in the payload for speculative deployments
        (``spec_k > 0``): token i is a guess for generated token i — this is
        how a cascade plants the light model's generation as the heavy
        model's draft.  ``deadline_s`` is the request's latency budget from
        THIS call; ``slo`` tags its class ("interactive" | "batch", default
        batch) — the issue queue derives priority from the class target when
        no explicit deadline is given, and preempting deployments may evict
        a batch victim's KV for an interactive waiter.  Transient store-seam
        failures retry with capped exponential backoff, and exhaustion
        completes the request with a structured error rather than raising
        after it was counted."""
        if self._stopped:
            raise RuntimeError(f"deployment {self.name!r} is stopped")
        key = f"{self.req_prefix}/{session_key}/{request_id}"
        with self._lock:
            self.submitted += 1
        self.node._note_submitted()
        t0 = time.monotonic()
        payload = {"prompt": np.asarray(prompt),
                   "max_new_tokens": max_new_tokens, "t0": t0}
        if draft_tokens is not None:
            payload["draft"] = np.asarray(draft_tokens, np.int32)
        if deadline_s is not None:
            payload["deadline_s"] = float(deadline_s)
        if slo is not None:
            payload["slo"] = str(slo)
        delay = self.retry_backoff_s
        for attempt in range(self.retry_budget + 1):
            try:
                return self.node.store.trigger_put(key, payload)
            except InjectedFault:
                with self._lock:
                    self.submit_retries += 1
                if attempt == self.retry_budget:
                    break
                time.sleep(delay)
                delay = min(delay * 2, 0.05)
        req = Request(request_id=request_id, session_key=session_key,
                      prompt=payload["prompt"],
                      max_new_tokens=max_new_tokens, deadline_s=deadline_s,
                      arrived_s=t0)
        self._fail_request(req, "store submit failed after retries")
        return None

    def result(self, request_id: str) -> np.ndarray | None:
        if self._stopped:
            return None          # out pool is gone with the deployment
        obj = self.node.store.get(f"{self.out_prefix}/{request_id}")
        return None if obj is None else np.asarray(obj.payload)

    def error(self, request_id: str):
        """Why a request was refused: an engine-rejection string, or a
        structured shed dict.  None while pending or on success."""
        if self._stopped:
            return None
        obj = self.node.store.get(f"{self.out_prefix}/{request_id}/error")
        return None if obj is None else obj.payload

    # --------------------------------------------------------------- stats
    def idle(self) -> bool:
        return all(eng.idle() for eng in self.engines)

    def stats(self) -> dict[str, Any]:
        """Latency/throughput/admission stats across this deployment."""
        ttft = sorted(t for e in self.engines for t in e.stats.ttft_s)
        tpot = sorted(t for e in self.engines for t in e.stats.tpot_s)
        queue_waits: dict[str, list[float]] = {}
        for e in self.engines:
            for slo, ws in e.stats.queue_wait_s.items():
                queue_waits.setdefault(slo, []).extend(ws)
        for ws in queue_waits.values():
            ws.sort()

        def pct(xs: list[float], q: float) -> float:
            return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else float("nan")

        with self._lock:
            shed, redirected = self.shed, self.redirected
            preempt_admits = self.preempt_admits
            submitted, completed = self.submitted, self.completed
            listener_errors = self.listener_errors
            fault = {"down": dict(self.down),
                     "failovers": self.failovers,
                     "rehomed": self.rehomed,
                     "migrated": self.migrated,
                     "replayed": self.replayed,
                     "failover_failed": self.failover_failed,
                     "submit_retries": self.submit_retries}
        drafted = sum(e.stats.spec_drafted for e in self.engines)
        accepted = sum(e.stats.spec_accepted for e in self.engines)
        return {
            "deployment": self.name,
            "paged": self.paged,
            # KV pool precision: storage dtype knob + measured bytes per
            # token slot (K/V + scale leaves over every layer) — the number
            # the quantization win is asserted on, independent of wall-clock
            "kv_dtype": (self.engines[0].cm.kv_dtype if self.paged
                         else None),
            "kv_bytes_per_token": (self.engines[0].cm.kv_bytes_per_token()
                                   if self.paged else 0.0),
            "n_replicas": len(self.engines),
            "submitted": submitted,
            "completed": completed,
            "shed": shed,
            "redirected": redirected,
            "listener_errors": listener_errors,
            "requests": sum(e.stats.prefills for e in self.engines),
            "tokens_out": sum(e.stats.tokens_out for e in self.engines),
            "per_replica_requests": [e.stats.prefills for e in self.engines],
            "queue_depths": [self.queue_depth(r)
                             for r in range(len(self.engines))],
            "host_syncs": sum(e.stats.host_syncs for e in self.engines),
            "ticks": sum(e.stats.ticks for e in self.engines),
            "decode_ticks": sum(e.stats.decode_ticks for e in self.engines),
            "prefill_batches": sum(e.stats.prefill_batches for e in self.engines),
            "prefill_chunks": sum(e.stats.prefill_chunks for e in self.engines),
            "prompt_tokens": sum(e.stats.prompt_tokens for e in self.engines),
            "prefill_tokens": sum(e.stats.prefill_tokens for e in self.engines),
            "prefix_hit_tokens": sum(e.stats.prefix_hit_tokens
                                     for e in self.engines),
            "prefix_hits": sum(e.stats.prefix_hits for e in self.engines),
            "blocks_in_use": sum(e.stats.blocks_in_use for e in self.engines),
            # speculative decoding counters (0s when spec_k == 0; the rate
            # follows EngineStats.spec_acceptance_rate's convention — NaN
            # when nothing was drafted, distinct from "all rejected")
            "spec_drafted": drafted,
            "spec_accepted": accepted,
            "spec_rolled_back": sum(e.stats.spec_rolled_back
                                    for e in self.engines),
            "spec_acceptance_rate": (accepted / drafted if drafted
                                     else float("nan")),
            # fault tolerance: replica health + failover + deadlines
            **fault,
            "deadline_exceeded": sum(e.stats.deadline_exceeded
                                     for e in self.engines),
            "spill_syncs": sum(e.stats.spill_syncs for e in self.engines),
            "spilled_sessions": sum(e.stats.spilled_sessions
                                    for e in self.engines),
            "adopted_sessions": sum(e.stats.adopted_sessions
                                    for e in self.engines),
            # overload preemption (issue-queue scheduler; zeros when off)
            "preempt": self.preempt,
            "preemptions": sum(e.stats.preemptions for e in self.engines),
            "spilled_blocks": sum(e.stats.spilled_blocks
                                  for e in self.engines),
            "resumes": sum(e.stats.resumes for e in self.engines),
            "preempt_admits": preempt_admits,
            **(self.spill_pool.stats() if self.spill_pool is not None
               else {}),
            # per-SLO-class queue wait (issued_s - arrived_s) histograms
            "queue_wait_s": {
                slo: {"n": len(ws),
                      "p50_s": pct(ws, 0.50), "p99_s": pct(ws, 0.99)}
                for slo, ws in sorted(queue_waits.items())},
            "ttft_p50_s": pct(ttft, 0.50), "ttft_p99_s": pct(ttft, 0.99),
            "tpot_p50_s": pct(tpot, 0.50), "tpot_p99_s": pct(tpot, 0.99),
        }

    # ------------------------------------------------------------ teardown
    def stop(self) -> None:
        """Tear the deployment down: unregister its lambdas, remove its
        req/out pools from the store, drop its KV pools from the device
        store.  Call after draining — in-flight requests are the owner's
        responsibility (the node cannot answer them once the out pool is
        gone)."""
        if self._stopped:
            return
        self._stopped = True
        for handle, wid in self._handles:
            self.node.store.unregister_lambda(handle, [wid])
        self.node.store.remove_pool(self.req_prefix)
        self.node.store.remove_pool(self.out_prefix)
        if self.spill_pool is not None:
            self.node.store.remove_pool(self.spill_prefix)
        if self.paged and self.node._kv_store is not None:
            self.node._kv_store.remove_prefix(f"/kv/{self.name}")
        if self.meshes:
            self.node.release_device_slices(self.meshes)
            self.meshes = []
        self.node.deployments.pop(self.name, None)


class ServeNode:
    """One multi-tenant serving node-group: shared workers + store + KV
    device store, hosting any number of ``ModelDeployment``s.

    The tick loop (``run_until_drained`` / ``step``) round-robins ticks
    over every busy engine of every deployment — in the paper's deployment
    each replica's loop runs on its own node; here one thread drives them
    all (the ticks release the GIL into the kernels and graph replays) while
    the workers' upcall threads keep feeding the schedulers concurrently.

    ``device`` is the node's one device (the card by default); the node
    raises before any worker thread starts when there is no card, so tests
    pass ``device="cpu"``.
    """

    def __init__(self, n_workers: int = 2, *, device="cuda") -> None:
        self.device = resolve_device(device, "ServeNode")
        # One upcall thread per worker: the single thread keeps FIFO
        # sessions ordered (the dispatcher's same-queue guarantee).
        self.workers = [Worker(i, n_upcall_threads=1)
                        for i in range(n_workers)]
        self.store = CascadeStore(self.workers)
        # One device store for every paged deployment's KV block pools
        # (keep_versions=1: decode rewrites all leaves each tick, retaining
        # predecessors would double pool memory).  Created lazily so a node
        # hosting only dense models allocates nothing.
        self._kv_store: DeviceStore | None = None
        self.deployments: dict[str, ModelDeployment] = {}
        self._lock = threading.Lock()
        self._submitted = 0
        self._completed = 0
        self._n_deployed = 0
        # Logical devices for mesh-sliced deployments (those of the node's
        # device type): slices are carved off this free list (disjoint per
        # replica) and returned on deployment stop().  Single-device
        # deployments never touch it.
        self._free_devices: list = [d for d in local_devices()
                                    if d.device.type == self.device.type]

    def kv_store(self) -> DeviceStore:
        if self._kv_store is None:
            self._kv_store = DeviceStore(self.device, keep_versions=1)
            self._kv_store.create_pool(PoolSpec(path="/kv"))
        return self._kv_store

    # ------------------------------------------------------- device slices
    def take_device_slices(self, n_slices: int, devices_per_slice: int):
        """Carve ``n_slices`` disjoint (1, devices_per_slice) meshes out of
        the node's free list of logical devices (``launch.mesh.
        mesh_slices``).  Raises ValueError when the list cannot cover the
        request — co-resident deployments hold their slices until
        stop()."""
        with self._lock:
            meshes = mesh_slices(n_slices, devices_per_slice,
                                 devices=self._free_devices)
            taken = n_slices * devices_per_slice
            self._free_devices = self._free_devices[taken:]
        return meshes

    def release_device_slices(self, meshes) -> None:
        with self._lock:
            for m in meshes:
                self._free_devices.extend(m.devices.flat)

    # --------------------------------------------------------- deployments
    def deploy(self, name: str, cfg: ModelConfig, params, *,
               n_replicas: int = 2, n_slots: int = 4, max_len: int = 64,
               policy: DispatchPolicy = DispatchPolicy.ROUND_ROBIN,
               temperature: float = 0.0, paged: bool | None = None,
               block_size: int = 16, num_blocks: int | None = None,
               prefix_cache: bool = True, token_budget: int | None = None,
               watermark: int | None = None,
               spec_k: int = 0, watchdog_s: float | None = None,
               retry_budget: int = 2,
               retry_backoff_s: float = 0.002,
               preempt: bool = False,
               spill_capacity_blocks: int = 256,
               kv_dtype: str | None = None,
               devices_per_replica: int | None = None) -> ModelDeployment:
        """Host ``cfg`` under ``/serve/<name>``; see ``ModelDeployment``.
        ``watermark`` bounds each replica's queue depth (None = unbounded).
        ``spec_k`` > 0 enables speculative decoding on paged engines: up to
        that many draft tokens verified per decode row per tick.
        ``watchdog_s`` arms the per-replica tick watchdog (None = off): a
        busy replica with no tick progress within the bound is marked down
        and its sessions re-home to siblings.  ``retry_budget`` /
        ``retry_backoff_s`` bound the transient-submit retry loop.
        ``preempt`` (paged only) arms EDF preemption: under pressure an
        engine may spill one in-flight victim's KV per tick into a
        deployment-wide host-side spill pool (``spill_capacity_blocks``)
        and admission turns preempt-before-shed for higher-priority
        arrivals.
        ``kv_dtype`` (paged only; default ``cfg.kv_dtype``) sets the KV
        block pool storage precision — ``"int8"``/``"fp8_e4m3"`` quantize
        on write with per-(block, slot, kv-head) scales and the kernels
        dequantize in-register, roughly halving decode HBM traffic;
        ``stats()["kv_bytes_per_token"]`` reports the measured footprint.
        ``devices_per_replica`` (paged only; default single-device) gives
        each replica its own DISJOINT mesh slice of that many logical
        devices: params and the KV block pool install placed over it and
        its tick runs tensor-parallel (``ServeEngine(mesh=...)``).
        """
        if name in self.deployments:
            raise ValueError(f"deployment {name!r} already exists")
        with self._lock:
            seed_base = self._n_deployed * 131
            self._n_deployed += 1
        dep = ModelDeployment(
            self, name, cfg, params, n_replicas=n_replicas, n_slots=n_slots,
            max_len=max_len, policy=policy, temperature=temperature,
            paged=paged, block_size=block_size, num_blocks=num_blocks,
            prefix_cache=prefix_cache, token_budget=token_budget,
            watermark=watermark, seed_base=seed_base, spec_k=spec_k,
            watchdog_s=watchdog_s, retry_budget=retry_budget,
            retry_backoff_s=retry_backoff_s, preempt=preempt,
            spill_capacity_blocks=spill_capacity_blocks, kv_dtype=kv_dtype,
            devices_per_replica=devices_per_replica)
        self.deployments[name] = dep
        return dep

    def deployment(self, name: str) -> ModelDeployment:
        return self.deployments[name]

    def install_faults(self, injector) -> None:
        """Install a ``serving.faults.FaultInjector`` at every seam: each
        deployed replica's tick/submit hooks plus the store's trigger_put
        hook.  Deploy first, then install (new deployments are not bound
        retroactively)."""
        for dep in self.deployments.values():
            dep.install_faults(injector)
        self.store.fault_hook = injector.store_hook()

    def undeploy(self, name: str) -> None:
        self.deployments[name].stop()

    # ----------------------------------------------------- request counting
    def _note_submitted(self) -> None:
        with self._lock:
            self._submitted += 1

    def _note_completed(self) -> None:
        with self._lock:
            self._completed += 1

    # ----------------------------------------------------------- tick loop
    def _idle(self) -> bool:
        return all(dep.idle() for dep in list(self.deployments.values()))

    def step(self) -> int:
        """Tick every busy engine across all deployments once; returns how
        many engines were busy.  Replica health runs here too: a crash
        (raised from the tick seam, or flagged from a submit-side fault)
        marks the replica down and re-homes its sessions; the per-replica
        watchdog catches wedged-but-not-crashed replicas; the down-sweep
        re-homes stragglers that raced into a dead replica's queue — so
        ``run_until_drained`` RESOLVES (every request reaches a terminal
        state) when a replica dies mid-drain, instead of timing out."""
        busy = 0
        for dep in list(self.deployments.values()):
            for r, eng in enumerate(dep.engines):
                if dep.is_down(r):
                    continue
                if eng.crashed:
                    dep.mark_down(r, "crashed")
                    continue
                if not eng.idle():
                    try:
                        eng.tick()
                    except ReplicaCrashed:
                        dep.mark_down(r, "crashed")
                        continue
                    busy += 1
            dep.check_watchdog()
            dep.sweep_down()
        return busy

    def _busy_report(self) -> str:
        """Name who is still holding the drain up (for TimeoutError)."""
        parts = []
        for dep in list(self.deployments.values()):
            if dep.down:
                parts.append(f"{dep.name}: down={dep.down}")
            for r, eng in enumerate(dep.engines):
                if not eng.idle():
                    parts.append(
                        f"{dep.name}/replica{r}(queued="
                        f"{eng.scheduler.pending(eng.replica_id)}, "
                        f"prefilling={len(eng.prefilling)}, "
                        f"decoding={len(eng.live)})")
        upcalls = sum(w.dispatcher.queue_depth() for w in self.workers)
        if upcalls:
            parts.append(f"{upcalls} in-flight upcall(s)")
        with self._lock:
            if self._completed < self._submitted:
                parts.append(f"{self._submitted - self._completed} request(s)"
                             f" awaiting completion")
        return "; ".join(parts) or "nothing visibly busy (lost completion?)"

    def run_until_drained(self, timeout_s: float = 60.0) -> None:
        """Tick every busy engine until every submitted request completed.

        Bounded by WALL CLOCK, not iteration count — idle spins while
        waiting on upcall delivery cost ~0.2 ms each and must not eat the
        budget of a slow prefill.  On timeout the error names the still-busy
        replicas and their queue states.
        """
        deadline = time.monotonic() + timeout_s
        while True:
            busy = self.step()
            if not busy:
                with self._lock:
                    done = self._completed == self._submitted
                if done and self._idle():
                    return
                time.sleep(0.0002)   # in-flight upcalls not yet enqueued
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"ServeNode did not drain within {timeout_s:.1f}s; "
                    f"still busy: {self._busy_report()}")

    # --------------------------------------------------------------- stats
    def stats(self) -> dict[str, Any]:
        with self._lock:
            submitted, completed = self._submitted, self._completed
        return {
            "n_workers": len(self.workers),
            "submitted": submitted,
            "completed": completed,
            "upcall_depths": [w.dispatcher.queue_depths()
                              for w in self.workers],
            "deployments": {name: dep.stats()
                            for name, dep in self.deployments.items()},
        }

    def close(self) -> None:
        self.store.close()

    def __enter__(self) -> "ServeNode":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ======================================================================
# Cascade escalation: light model first, heavy only when the gate trips
# ======================================================================
@dataclass
class CascadeGate:
    """The escalation decision (CascadeServe): a request whose light-model
    generation looks UNCERTAIN is re-run on the heavy model.

    ``metric="logprob"``: escalate when the mean per-token log-likelihood of
    the light generation falls below ``threshold`` (the model was guessing).
    ``metric="entropy"``: escalate when the mean next-token entropy exceeds
    ``threshold``.  Both read the per-token scores the engine's in-dispatch
    sampler surfaced — no extra device traffic, no logits on host.
    """
    metric: str = "logprob"
    threshold: float = -1.0

    def __post_init__(self) -> None:
        if self.metric not in ("logprob", "entropy"):
            raise ValueError(f"unknown gate metric {self.metric!r}")

    def trips(self, req: Request) -> bool:
        if self.metric == "logprob":
            return req.mean_logprob() < self.threshold
        return req.mean_entropy() > self.threshold


class CascadeRoute:
    """Submit to the light deployment; escalate gated requests to the heavy
    one via an internal trigger_put into its req pool (the request moves to
    the weights — the weights never move).

    ``escalate_on_error=True`` also fails over requests the light
    deployment refused (shed under overload, engine rejection) — the heavy
    deployment is the fallback path, with its own watermark as the final
    bound.  ``result()`` resolves to the heavy answer for escalated
    requests and the light answer otherwise.

    ``draft_from_light=True`` makes the cascade SELF-DRAFTING: a
    gate-escalated request carries the light model's generation as its
    draft stream, and a speculative heavy deployment (``spec_k > 0``)
    verifies those tokens k at a time in its one ragged dispatch instead of
    re-deriving them one tick each — the light model's work is never wasted
    (CascadeServe), it is the heavy model's draft model.  Wherever the
    heavy model agrees with the light answer, decode ticks collapse; where
    it disagrees, the acceptance rule rejects the drafts and the output is
    exactly what the heavy model alone would have produced.
    """

    def __init__(self, light: ModelDeployment, heavy: ModelDeployment,
                 gate: CascadeGate | None = None, *,
                 escalate_on_error: bool = True,
                 draft_from_light: bool = True) -> None:
        if light.node is not heavy.node:
            raise ValueError("cascade endpoints must share one ServeNode")
        self.light = light
        self.heavy = heavy
        self.gate = gate or CascadeGate()
        self.escalate_on_error = escalate_on_error
        self.draft_from_light = draft_from_light
        self._lock = threading.Lock()
        self._pending: dict[str, tuple[str, np.ndarray, int,
                                       float | None, float]] = {}
        # bounded like ModelDeployment.routed: a long-running route must not
        # grow per-request state forever (insertion-order eviction)
        self._escalated: dict[str, None] = {}
        self._escalated_cap = 4096
        self.requests = 0
        self.gate_trips = 0       # escalations decided by the gate
        self.error_failovers = 0  # escalations because light refused
        self.deadline_skips = 0   # escalations skipped: no budget left
        self.escalation_failures = 0  # heavy submits that failed after
        #                               retries (the light answer stands)
        light.on_done.append(self._on_light_done)

    # ------------------------------------------------------------- clients
    def submit(self, session_key: str, request_id: str, prompt: Any, *,
               max_new_tokens: int = 16, deadline_s: float | None = None):
        p = np.asarray(prompt)
        # record BEFORE submitting (the completion listener may fire before
        # submit returns), and roll back if the submit never happened — a
        # failed submit must not skew escalation_rate or leak the entry
        # (every request that does enter the light deployment completes —
        # served, rejected, or shed — so _pending is otherwise bounded by
        # what is in flight).  ``deadline_s`` is the END-TO-END budget from
        # this call: the heavy tier gets whatever remains after light.
        t0 = time.monotonic()
        with self._lock:
            self.requests += 1
            self._pending[request_id] = (session_key, p, max_new_tokens,
                                         deadline_s, t0)
        try:
            return self.light.submit(session_key, request_id, p,
                                     max_new_tokens=max_new_tokens,
                                     deadline_s=deadline_s)
        except BaseException:
            with self._lock:
                self.requests -= 1
                self._pending.pop(request_id, None)
            raise

    def escalated(self, request_id: str) -> bool:
        with self._lock:
            return request_id in self._escalated

    def _resolve(self, request_id: str) -> ModelDeployment:
        """Which deployment's answer is authoritative.  A RECENT escalation
        (still in the bounded set) resolves to heavy even while the heavy
        answer is pending; an escalation old enough to have been evicted
        from the set still resolves correctly because the heavy answer is
        DURABLE in the heavy out pool — eviction only loses the
        pending-escalation window, never the answer."""
        if self.escalated(request_id):
            return self.heavy
        if self.heavy.result(request_id) is not None:
            return self.heavy
        return self.light

    def result(self, request_id: str) -> np.ndarray | None:
        return self._resolve(request_id).result(request_id)

    def error(self, request_id: str):
        return self._resolve(request_id).error(request_id)

    # ---------------------------------------------------------- escalation
    def _on_light_done(self, req: Request) -> None:
        """Light-deployment completion listener: runs the gate and, when it
        trips, fires the internal trigger_put into the heavy pool.  Runs on
        the node's tick thread (engine completions) or a worker upcall
        thread (rejections/sheds) — before the light response is put, so
        the heavy submission is always counted before this completion and
        the node can never observe a false drain."""
        with self._lock:
            info = self._pending.pop(req.request_id, None)
        if info is None:
            return                      # not routed through this cascade
        session, prompt, max_new, deadline, t0 = info
        if req.error is not None:
            # a deadline_exceeded from the light tier is terminal: the
            # budget is spent, escalating would only burn heavy capacity on
            # an answer the client has already written off
            if (isinstance(req.error, dict)
                    and req.error.get("error") == "deadline_exceeded"):
                with self._lock:
                    self.deadline_skips += 1
                return
            if not self.escalate_on_error:
                return
            reason = "error_failover"
        elif self.gate.trips(req):
            reason = "gate"
        else:
            return
        # deadline-aware escalation: the heavy tier only gets what remains
        # of the END-TO-END budget.  An exhausted budget skips escalation —
        # the light answer stands (or its error does) rather than queueing
        # heavy work guaranteed to expire.
        remaining: float | None = None
        if deadline is not None:
            remaining = deadline - (time.monotonic() - t0)
            if remaining <= 0:
                with self._lock:
                    self.deadline_skips += 1
                return
        # submit FIRST, record after: a failed heavy submit (e.g. stopped
        # deployment) must not leave the request marked escalated — the
        # route would then resolve to a heavy answer that can never come.
        # The reverse race (heavy completing before the set is updated) is
        # harmless: _resolve falls back to the durable heavy out pool.
        # Self-drafting: a gate escalation ships the light generation as the
        # heavy deployment's draft stream (error failovers have no tokens).
        draft = (np.asarray(req.tokens, np.int32)
                 if self.draft_from_light and reason == "gate" and req.tokens
                 else None)
        # bounded retry: a heavy replica crashing at the submit seam (or an
        # injected transient) must not strand the request — retry briefly,
        # and on exhaustion let the light answer stand rather than raising
        # into the completion listener (satellite: heavy-tier crash after a
        # successful light pass must resolve, never pend forever).  A
        # submit that the deployment itself contains (returns None after
        # _fail_request) resolves via the heavy error path.
        delay = 0.002
        for attempt in range(3):
            try:
                self.heavy.submit(session, req.request_id, prompt,
                                  max_new_tokens=max_new, draft_tokens=draft,
                                  deadline_s=remaining)
                break
            except (ReplicaCrashed, InjectedFault):
                if attempt == 2:
                    with self._lock:
                        self.escalation_failures += 1
                    return
                time.sleep(delay)
                delay = min(delay * 2, 0.05)
        with self._lock:
            self._escalated[req.request_id] = None
            while len(self._escalated) > self._escalated_cap:
                self._escalated.pop(next(iter(self._escalated)))
            if reason == "gate":
                self.gate_trips += 1
            else:
                self.error_failovers += 1

    # --------------------------------------------------------------- stats
    def stats(self) -> dict[str, Any]:
        with self._lock:
            n, trips, fails = self.requests, self.gate_trips, \
                self.error_failovers
            skips, esc_fails = self.deadline_skips, self.escalation_failures
        return {
            "light": self.light.name, "heavy": self.heavy.name,
            "metric": self.gate.metric, "threshold": self.gate.threshold,
            "requests": n,
            "escalated": trips + fails,
            "gate_trips": trips,
            "error_failovers": fails,
            "deadline_skips": skips,
            "escalation_failures": esc_fails,
            "escalation_rate": (trips + fails) / n if n else float("nan"),
        }


# ======================================================================
# Single-model convenience wrapper (the pre-multi-tenant API)
# ======================================================================
class ServeCluster:
    """One model on its own ``ServeNode`` — the single-tenant special case.

    Kept as the convenience entry point (tests, benchmarks, quick scripts):
    construct with a config and params and get N replicas behind the fast
    path, exactly as before the node/deployment split.  Multi-model hosting,
    bounded admission and cascade routing live on ``ServeNode`` /
    ``ModelDeployment`` / ``CascadeRoute``.
    """

    def __init__(self, cfg: ModelConfig, params, *, n_replicas: int = 2,
                 n_slots: int = 4, max_len: int = 64,
                 policy: DispatchPolicy = DispatchPolicy.ROUND_ROBIN,
                 model_name: str | None = None,
                 temperature: float = 0.0, paged: bool | None = None,
                 block_size: int = 16, num_blocks: int | None = None,
                 prefix_cache: bool = True,
                 token_budget: int | None = None,
                 watermark: int | None = None,
                 spec_k: int = 0,
                 watchdog_s: float | None = None,
                 retry_budget: int = 2,
                 retry_backoff_s: float = 0.002,
                 preempt: bool = False,
                 spill_capacity_blocks: int = 256,
                 kv_dtype: str | None = None,
                 devices_per_replica: int | None = None,
                 device="cuda") -> None:
        self.node = ServeNode(n_workers=n_replicas, device=device)
        self.dep = self.node.deploy(
            model_name or cfg.name, cfg, params, n_replicas=n_replicas,
            n_slots=n_slots, max_len=max_len, policy=policy,
            temperature=temperature, paged=paged, block_size=block_size,
            num_blocks=num_blocks, prefix_cache=prefix_cache,
            token_budget=token_budget, watermark=watermark, spec_k=spec_k,
            watchdog_s=watchdog_s, retry_budget=retry_budget,
            retry_backoff_s=retry_backoff_s, preempt=preempt,
            spill_capacity_blocks=spill_capacity_blocks, kv_dtype=kv_dtype,
            devices_per_replica=devices_per_replica)
        self.cfg = cfg
        self.policy = policy

    # ------------------------------------------------ delegated attributes
    @property
    def workers(self):
        return self.node.workers

    @property
    def store(self):
        return self.node.store

    @property
    def kv_store(self):
        return self.node._kv_store

    @property
    def engines(self):
        return self.dep.engines

    @property
    def routed(self):
        return self.dep.routed

    @property
    def paged(self):
        return self.dep.paged

    @property
    def req_prefix(self):
        return self.dep.req_prefix

    @property
    def out_prefix(self):
        return self.dep.out_prefix

    # ------------------------------------------------------------- clients
    def submit(self, session_key: str, request_id: str, prompt: Any, *,
               max_new_tokens: int = 16, deadline_s: float | None = None,
               slo: str | None = None):
        return self.dep.submit(session_key, request_id, prompt,
                               max_new_tokens=max_new_tokens,
                               deadline_s=deadline_s, slo=slo)

    def result(self, request_id: str) -> np.ndarray | None:
        return self.dep.result(request_id)

    def error(self, request_id: str):
        err = self.dep.error(request_id)
        return None if err is None else str(err)

    def run_until_drained(self, timeout_s: float = 60.0) -> None:
        self.node.run_until_drained(timeout_s)

    def stats(self) -> dict[str, Any]:
        return self.dep.stats()

    def close(self) -> None:
        self.node.close()

    def __enter__(self) -> "ServeCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
