"""The fast-path dispatcher (§3.3, Fig 2).

(Copied from the JAX package's ``core/dispatcher.py``, whose package
``__init__`` imports jax.)

Design points taken directly from the paper:

- the dispatcher observes the stream of K/V updates (①), its *only* role is
  trie prefix matching (②) and enqueueing an upcall event holding a pair of
  references to the object and the matched lambda (③) — it never runs user
  code (direct upcalls from the system thread "could disrupt the entire
  system"; a fork-per-event dispatcher "thrashes");
- a small, fixed pool of upcall threads, each with **its own event queue**,
  dequeues and calls the lambda (④);
- round-robin enqueueing by default; lambdas configured FIFO get a queue
  picked by the key hash of the object so same-key objects stay ordered on
  one thread (e.g. frames from one camera).

Queue-depth introspection: each queue tracks how many events are outstanding
on it (enqueued but not yet *finished* — the event a thread is currently
running still counts).  ``Dispatcher.queue_depths`` exposes the vector, so
admission-control layers (e.g. the serving node's bounded per-replica queues)
can observe backlog building up behind a slow lambda and shed or redirect
before the tail latency does it for them.
"""
from __future__ import annotations

import queue
import threading
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable

from .objects import CascadeObject, monotonic_ns
from .pools import DispatchPolicy
from .trie import PathTrie

UpcallFn = Callable[[CascadeObject, "UpcallEvent"], Any]


@dataclass(frozen=True)
class LambdaHandle:
    name: str
    prefix: str
    fn: UpcallFn
    dispatch: DispatchPolicy = DispatchPolicy.ROUND_ROBIN
    # FIFO queue pick hash; None = crc32 over the full key.  Mirrors the
    # store-level trigger-put member pick: pools with an affinity hash (e.g.
    # ``affinity_shard_hash`` over a session prefix) can group related keys
    # onto ONE upcall queue even when the worker runs several, instead of
    # only same-key objects sharing a queue.
    queue_hash: Callable[[str], int] | None = None


@dataclass
class UpcallEvent:
    """A (object-ref, lambda-ref) pair — shared pointers in the paper."""

    obj: CascadeObject
    handle: LambdaHandle
    enqueued_ns: int = 0
    dequeued_ns: int = 0
    done_ns: int = 0
    result: Any = None
    error: BaseException | None = None
    completion: threading.Event = field(default_factory=threading.Event)


_STOP = object()


class UpcallThreadPool:
    """Fixed pool; each thread loops over its own queue (Fig 2 right side)."""

    def __init__(self, n_threads: int = 4, name: str = "upcall") -> None:
        self.queues: list[queue.SimpleQueue] = [queue.SimpleQueue() for _ in range(n_threads)]
        # outstanding events per queue: incremented at submit, decremented
        # only after the lambda RETURNS, so a blocked upcall thread shows up
        # as depth (1 running + k queued), which is exactly the backlog an
        # admission watermark needs to see.  Also tracked per handle NAME,
        # so a multi-tenant consumer can watermark against ITS OWN in-flight
        # events rather than every tenant's traffic on the shared worker.
        self._depths = [0] * n_threads
        self._handle_depths: dict[str, int] = {}
        # lambda exceptions per queue: the upcall thread CONTAINS a raising
        # lambda (the error rides on the event for any waiter; the thread
        # keeps serving), and this counts the containments so operators can
        # see a poisoned lambda instead of silently losing its events.
        self._errors = [0] * n_threads
        self._depth_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._loop, args=(q, i), daemon=True, name=f"{name}-{i}")
            for i, q in enumerate(self.queues)
        ]
        for t in self._threads:
            t.start()

    def __len__(self) -> int:
        return len(self.queues)

    def _loop(self, q: queue.SimpleQueue, idx: int) -> None:
        while True:
            ev = q.get()
            if ev is _STOP:
                return
            ev.dequeued_ns = monotonic_ns()
            try:
                ev.result = ev.handle.fn(ev.obj, ev)
            except BaseException as e:  # surfaced to the waiter, not swallowed
                ev.error = e
            ev.done_ns = monotonic_ns()
            with self._depth_lock:
                if ev.error is not None:
                    self._errors[idx] += 1
                self._depths[idx] -= 1
                name = ev.handle.name
                left = self._handle_depths.get(name, 0) - 1
                if left > 0:
                    self._handle_depths[name] = left
                else:
                    self._handle_depths.pop(name, None)
            ev.completion.set()

    def submit(self, ev: UpcallEvent, queue_index: int) -> None:
        ev.enqueued_ns = monotonic_ns()
        idx = queue_index % len(self.queues)
        with self._depth_lock:
            self._depths[idx] += 1
            name = ev.handle.name
            self._handle_depths[name] = self._handle_depths.get(name, 0) + 1
        self.queues[idx].put(ev)

    def depths(self) -> list[int]:
        """Outstanding (queued + in-flight) events per queue."""
        with self._depth_lock:
            return list(self._depths)

    def depth(self) -> int:
        """Total outstanding events across all queues."""
        with self._depth_lock:
            return sum(self._depths)

    def depth_for(self, handle_name: str) -> int:
        """Outstanding events for ONE lambda handle (by name)."""
        with self._depth_lock:
            return self._handle_depths.get(handle_name, 0)

    def errors(self) -> list[int]:
        """Contained lambda exceptions per queue."""
        with self._depth_lock:
            return list(self._errors)

    def stop(self) -> None:
        for q in self.queues:
            q.put(_STOP)
        for t in self._threads:
            t.join(timeout=5)


class Dispatcher:
    """Trie match → pick queue → enqueue.  Runs on the caller (system) thread;
    the cost it adds to the critical path is exactly steps ②+③."""

    def __init__(self, pool: UpcallThreadPool) -> None:
        self._trie: PathTrie[LambdaHandle] = PathTrie()
        self._pool = pool
        self._rr = 0
        self._lock = threading.Lock()
        self.dispatched = 0

    def register(self, handle: LambdaHandle) -> None:
        self._trie.insert(handle.prefix, handle)

    def unregister(self, handle: LambdaHandle) -> bool:
        return self._trie.remove(handle.prefix, handle)

    def match(self, key: str) -> list[LambdaHandle]:
        return self._trie.match(key)

    def queue_depths(self) -> list[int]:
        """Per-upcall-queue outstanding event counts (queued + running).
        This is the dispatcher's contribution to a node's backlog; consumers
        add their own post-upcall queues (e.g. an engine's scheduler)."""
        return self._pool.depths()

    def queue_depth(self, handle_name: str | None = None) -> int:
        """Outstanding upcall events on this worker — all of them, or only
        those bound for one lambda (by handle name), so a multi-tenant
        admission layer can watermark against its own traffic."""
        if handle_name is not None:
            return self._pool.depth_for(handle_name)
        return self._pool.depth()

    def stats(self) -> dict[str, Any]:
        """Dispatch/containment counters: ``dispatched`` events total,
        ``upcall_errors`` (lambda exceptions the pool contained — the event
        carries the error, the thread survives) and their per-queue split."""
        errors = self._pool.errors()
        with self._lock:
            dispatched = self.dispatched
        return {
            "dispatched": dispatched,
            "upcall_errors": sum(errors),
            "upcall_errors_per_queue": errors,
        }

    def dispatch(self, obj: CascadeObject) -> list[UpcallEvent]:
        """One incoming object may match multiple prefixes → multiple events.
        Only references are enqueued; the payload is never copied."""
        events: list[UpcallEvent] = []
        for handle in self._trie.match(obj.key):
            ev = UpcallEvent(obj=obj, handle=handle)
            if handle.dispatch is DispatchPolicy.FIFO:
                qi = (handle.queue_hash(obj.key) if handle.queue_hash
                      else zlib.crc32(obj.key.encode()))
            else:
                with self._lock:
                    qi = self._rr
                    self._rr += 1
            self._pool.submit(ev, qi)
            events.append(ev)
        if events:
            with self._lock:  # dispatch() is called from concurrent putters
                self.dispatched += len(events)
        return events
