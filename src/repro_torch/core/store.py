"""The sharded, versioned K/V object store (§3.2) spanning worker nodes.

(Copied from the JAX package's ``core/store.py``, whose package
``__init__`` imports jax.)

A ``Worker`` models one Cascade node: an in-memory volatile store (seqlock
cells + version chains), per-pool persistent logs, an LRU for secondarily
accessed objects, and the fast-path machinery (dispatcher + upcall pool).

``CascadeStore`` is the service-wide store: it owns the pool registry and the
pool→shard maps, and implements the three put flavors:

- ``trigger_put`` — deliver the object to ONE member of the home shard (round
  robin for RR pools, emulating the paper's random P2P choice
  deterministically; key-hash for FIFO pools so same-key/session objects keep
  one node and stay ordered) and dispatch upcalls there.  Nothing is stored
  (§3.2).
- ``put`` on a volatile pool — atomic multicast: deliver to ALL members of
  the home shard in sequence order so replicas stay identical; upcalls are
  dispatched on the round-robin-selected processing member (§3.5).
- ``put`` on a persistent pool — additionally append to every member's
  persistent log and acknowledge once durable everywhere (the paper's Paxos
  acknowledges after all replicas persist).

``get`` goes to a uniformly-chosen member of the home shard (replicas hold
identical state) and reads through the seqlock without locks.  Versioned and
temporal gets are served by the version chains / persistent logs.
"""
from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass, field
from typing import Any, Iterable

from .dispatcher import Dispatcher, LambdaHandle, UpcallEvent, UpcallThreadPool
from .log import PersistentLog
from .objects import INVALID_VERSION, CascadeObject, monotonic_ns
from .placement import LRUCache, RoundRobin, ShardMap, build_shard_map
from .pools import DispatchPolicy, Persistence, PoolRegistry, PoolSpec
from .versioning import VersionChain


class Worker:
    """One Cascade node: storage + fast path."""

    def __init__(self, worker_id: int, *, n_upcall_threads: int = 2,
                 lru_bytes: int = 64 << 20, log_dir: str | None = None) -> None:
        self.worker_id = worker_id
        self.volatile: dict[str, VersionChain] = {}
        self._volatile_lock = threading.Lock()
        self.logs: dict[str, PersistentLog] = {}
        self._logs_lock = threading.Lock()
        self.lru = LRUCache(lru_bytes)
        self.upcalls = UpcallThreadPool(n_upcall_threads, name=f"w{worker_id}-upcall")
        self.dispatcher = Dispatcher(self.upcalls)
        self._log_dir = log_dir
        self.stored_objects = 0

    # -- storage -----------------------------------------------------------
    def _chain(self, key: str) -> VersionChain:
        chain = self.volatile.get(key)
        if chain is None:
            with self._volatile_lock:
                chain = self.volatile.setdefault(key, VersionChain())
        return chain

    def store(self, obj: CascadeObject, version: int) -> CascadeObject:
        stamped = self._chain(obj.key).append(obj, version)
        self.stored_objects += 1
        return stamped

    def persist_async(self, pool: PoolSpec, obj: CascadeObject):
        """Queue the record; returns (stamped obj, this record's stability
        event) so the caller can overlap replicas' disk I/O and then await
        exactly its own records."""
        log = self.logs.get(pool.path)
        if log is None:
            with self._logs_lock:  # two first-puts must not double-open the file
                log = self.logs.get(pool.path)
                if log is None:
                    base = self._log_dir or os.path.join(".cascade_logs",
                                                         f"w{self.worker_id}")
                    fname = pool.path.strip("/").replace("/", "_") + ".log"
                    log = self.logs[pool.path] = PersistentLog(
                        os.path.join(base, fname))
        payload = obj.payload
        if not isinstance(payload, (bytes, bytearray)):
            payload = _to_bytes(payload)
        return log.append_nowait(obj.key, bytes(payload),
                                 ts_ns=obj.timestamp_ns or None)

    def load_latest(self, key: str) -> CascadeObject | None:
        chain = self.volatile.get(key)
        return chain.latest() if chain else None

    def close(self) -> None:
        self.upcalls.stop()
        for log in self.logs.values():
            log.close()


def _to_bytes(payload: Any) -> bytes:
    import numpy as np

    arr = np.asarray(payload)
    return arr.tobytes()


@dataclass
class PutReceipt:
    obj: CascadeObject
    events: list[UpcallEvent] = field(default_factory=list)
    processing_worker: int = -1

    def wait(self, timeout: float | None = 10.0) -> list[Any]:
        out = []
        for ev in self.events:
            if not ev.completion.wait(timeout):
                raise TimeoutError(f"upcall {ev.handle.name} did not complete")
            if ev.error is not None:
                raise ev.error
            out.append(ev.result)
        return out


class CascadeStore:
    """Service-wide sharded store over a set of workers."""

    def __init__(self, workers: Iterable[Worker]) -> None:
        self.workers: dict[int, Worker] = {w.worker_id: w for w in workers}
        self.pools = PoolRegistry()
        self._shard_maps: dict[str, ShardMap] = {}
        self._sequencers: dict[tuple[str, int], threading.Lock] = {}
        self._versions: dict[tuple[str, int], int] = {}
        self._rr = RoundRobin()
        self._meta_lock = threading.Lock()
        # fault-injection seam (serving.faults.FaultInjector.store_hook):
        # called with the key at trigger_put ENTRY; a raising hook models a
        # transient send failure the CALLER retries (nothing was counted,
        # nothing dispatched).  None in production.
        self.fault_hook = None

    # -- pool management -----------------------------------------------------
    def create_pool(self, spec: PoolSpec, worker_ids: list[int] | None = None) -> PoolSpec:
        ids = worker_ids if worker_ids is not None else sorted(self.workers)
        self.pools.create(spec)
        with self._meta_lock:  # remove_pool deletes from _shard_maps under it
            self._shard_maps[spec.path] = build_shard_map(
                spec.path, ids, spec.replication)
        return spec

    def _route(self, key: str) -> tuple[PoolSpec, tuple[int, ...]]:
        spec = self.pools.lookup(key)
        if spec is None:
            raise KeyError(f"no pool owns key {key!r}")
        members = self._shard_maps[spec.path].members(spec, key)
        return spec, members

    def remove_pool(self, path: str) -> None:
        """Tear a pool down: registry entry, shard map, shard sequencers and
        version counters, every member's stored objects under the pool's
        prefix, and any open persistent-log handles (the on-disk log FILE is
        left in place — persistent pools are durable by definition, and a
        re-created pool resumes its log the way a restarted node would).
        Lambdas registered on the pool's prefix must be unregistered by
        their owner first (``unregister_lambda``) — the store cannot know
        which handles belong to the departing service."""
        spec = self.pools.remove(path)
        with self._meta_lock:
            self._shard_maps.pop(path, None)
            for k in [k for k in self._sequencers if k[0] == path]:
                del self._sequencers[k]
            for k in [k for k in self._versions if k[0] == path]:
                del self._versions[k]
        for w in self.workers.values():
            with w._volatile_lock:
                for key in [k for k in w.volatile if spec.owns(k)]:
                    del w.volatile[key]
            with w._logs_lock:
                log = w.logs.pop(path, None)
            if log is not None:
                log.close()

    def register_lambda(self, handle: LambdaHandle, worker_ids: list[int] | None = None) -> None:
        """Bind a lambda to a path prefix on the given (default: all owning)
        workers — in the paper the DFG determines which shard hosts each
        lambda; here the caller passes the stage's shard members."""
        targets = worker_ids if worker_ids is not None else list(self.workers)
        for wid in targets:
            self.workers[wid].dispatcher.register(handle)

    def unregister_lambda(self, handle: LambdaHandle,
                          worker_ids: list[int] | None = None) -> None:
        """Unbind a lambda from its prefix (deployment teardown): later puts
        to the prefix no longer upcall it.  Events already enqueued still
        run — teardown should drain first."""
        targets = worker_ids if worker_ids is not None else list(self.workers)
        for wid in targets:
            self.workers[wid].dispatcher.unregister(handle)

    # -- puts ------------------------------------------------------------------
    def _next_version(self, pool: PoolSpec, shard: int) -> tuple[int, threading.Lock]:
        k = (pool.path, shard)
        with self._meta_lock:
            lock = self._sequencers.setdefault(k, threading.Lock())
        return k, lock

    def trigger_put(self, key: str, payload: Any, *, principal: str = "") -> PutReceipt:
        """P2P send to one member + upcall; nothing stored, nothing replicated.

        Member selection follows the pool's dispatch policy, mirroring the
        dispatcher's queue selection (§3.3) one level up: ROUND_ROBIN spreads
        trigger-puts across the home shard, FIFO picks the member by the
        pool's key hash so same-key (or, with ``affinity_shard_hash``,
        same-session) objects always land on the same node, in order.
        """
        if self.fault_hook is not None:
            self.fault_hook(key)
        spec, members = self._route(key)
        if not spec.can_write(principal):
            raise PermissionError(f"{principal!r} cannot write {spec.path}")
        if spec.dispatch is DispatchPolicy.FIFO:
            # The low bits of the hash already chose the home shard
            # (h % n_shards); pick the member from the HIGH bits so the two
            # moduli are decorrelated — otherwise gcd(n_shards, replication)
            # > 1 leaves whole member subsets permanently unreachable.
            h = spec.shard_hash(key)
            n_shards = len(self._shard_maps[spec.path].shards)
            target = members[(h // max(1, n_shards)) % len(members)]
        else:
            target = self._rr.pick(("trig", spec.path), members)
        obj = CascadeObject(key=key, payload=payload, version=INVALID_VERSION,
                            timestamp_ns=monotonic_ns())
        events = self.workers[target].dispatcher.dispatch(obj)
        return PutReceipt(obj=obj, events=events, processing_worker=target)

    def put(self, key: str, payload: Any, *, principal: str = "") -> PutReceipt:
        """Volatile/persistent put: replicate to the full home shard."""
        spec, members = self._route(key)
        if not spec.can_write(principal):
            raise PermissionError(f"{principal!r} cannot write {spec.path}")
        if spec.persistence is Persistence.TRANSIENT:
            return self.trigger_put(key, payload, principal=principal)
        shard_idx = self._shard_maps[spec.path].home_shard(spec, key)
        vkey, seq_lock = self._next_version(spec, shard_idx)
        obj = CascadeObject(key=key, payload=payload, timestamp_ns=monotonic_ns())
        with seq_lock:  # atomic multicast: identical order at every replica
            version = self._versions.get(vkey, -1) + 1
            # lint: guarded-by(seq_lock) per-(pool,shard) sequencer, not _meta_lock, serializes writers of this vkey
            self._versions[vkey] = version
            stamped = None
            for wid in members:
                stamped = self.workers[wid].store(obj, version)
        if spec.persistence is Persistence.PERSISTENT:
            # All replicas persist before the put is acknowledged (§3.2).
            # Appends are issued without waiting so the members' write-back
            # threads overlap their disk I/O, then stability is awaited for
            # THIS put's record on EVERY member's log — not just the last
            # one's, and not the whole queue (concurrent puts stay
            # independent).
            pending = [self.workers[wid].persist_async(spec, obj)[1]
                       for wid in members]
            for done in pending:
                if not done.wait(10.0):
                    raise TimeoutError(
                        "persistent put did not stabilize on all replicas")
        # Round-robin processing member (§3.5); replicas all HOLD the data,
        # exactly one dispatches the upcall for this object.
        proc = self._rr.pick(("proc", spec.path, shard_idx), members)
        events = self.workers[proc].dispatcher.dispatch(stamped)
        return PutReceipt(obj=stamped, events=events, processing_worker=proc)

    # -- gets ------------------------------------------------------------------
    def get(self, key: str, *, principal: str = "") -> CascadeObject | None:
        """Linearizable read from a random home-shard member (states are
        identical, so any member may answer)."""
        spec, members = self._route(key)
        if not spec.can_read(principal):
            raise PermissionError(f"{principal!r} cannot read {spec.path}")
        w = self.workers[random.choice(members)]
        obj = w.load_latest(key)
        if obj is not None:
            w.lru.put(key, obj, obj.nbytes())
        return obj

    def get_version(self, key: str, version: int) -> CascadeObject | None:
        _, members = self._route(key)
        chain = self.workers[random.choice(members)].volatile.get(key)
        return chain.at_version(version) if chain else None

    def get_time(self, key: str, ts_ns: int) -> CascadeObject | None:
        """Temporal get (persistent pools): resolved via the member's log so
        the stable-prefix rule applies."""
        spec, members = self._route(key)
        w = self.workers[random.choice(members)]
        if spec.persistence is Persistence.PERSISTENT and spec.path in w.logs:
            return w.logs[spec.path].get_time(key, ts_ns)
        chain = w.volatile.get(key)
        return chain.at_time(ts_ns) if chain else None

    def time_range(self, key: str, lo_ns: int, hi_ns: int) -> list[CascadeObject]:
        spec, members = self._route(key)
        w = self.workers[random.choice(members)]
        if spec.persistence is Persistence.PERSISTENT and spec.path in w.logs:
            return w.logs[spec.path].time_range(key, lo_ns, hi_ns)
        chain = w.volatile.get(key)
        return chain.time_range(lo_ns, hi_ns) if chain else []

    def close(self) -> None:
        for w in self.workers.values():
            w.close()


class SpillPool:
    """Host-side parking lot for preempted KV (ROADMAP item 2's missing
    piece: before this, spilled KV could only re-home IMMEDIATELY on a
    failover sibling — ``PagedCacheManager.spill_device`` had nowhere to
    park).

    Entries are opaque to the pool (the engine parks
    ``kvcache.SpilledKV`` host copies pulled through its one sync site);
    capacity is accounted in KV BLOCKS because that is the unit the device
    pool frees and the unit a resume re-acquires.  When ``store`` is given,
    each parked entry is also published as a Cascade object under
    ``prefix/<request_id>`` on the store's volatile pool — so a sibling
    replica (same node, shared store) can unpark a session that was
    preempted on a replica that later died, and observers can watch spill
    traffic like any other pool.  The store has no per-key delete, so
    unpark/discard/evict write a ``None`` TOMBSTONE version; readers of the
    pool must treat a ``None`` payload as absent (``unpark`` does).

    Bounded: parking beyond ``capacity_blocks`` evicts the OLDEST parked
    entries first (their sessions fall back to prompt replay — a
    correctness-preserving downgrade, exactly the failover fallback), and a
    single entry larger than the whole pool is refused (``park`` → False,
    caller replays).  Tick-thread-only by design, like the allocator it
    shadows: every park/unpark happens inside an engine tick on the
    deployment's tick loop, so there is no lock to take.
    """

    def __init__(self, *, capacity_blocks: int = 256,
                 store: "CascadeStore | None" = None,
                 prefix: str = "/spill") -> None:
        self.capacity_blocks = capacity_blocks
        self.store = store
        self.prefix = prefix.rstrip("/")
        self._entries: dict[str, tuple[Any, int]] = {}  # rid -> (entry, blocks)
        self.blocks = 0          # gauge: blocks currently parked
        self.parked = 0          # counters, cumulative
        self.unparked = 0
        self.evicted = 0

    def _publish(self, request_id: str, entry: Any) -> None:
        if self.store is not None:
            self.store.put(f"{self.prefix}/{request_id}", entry)

    def park(self, request_id: str, entry: Any, n_blocks: int) -> bool:
        """Park a spilled session's KV; False when it can never fit (the
        caller falls back to prompt replay).  Evicts oldest-first to make
        room — evicted sessions also degrade to replay on resume."""
        if n_blocks > self.capacity_blocks:
            return False
        self.discard(request_id)  # re-park replaces (failover double-spill)
        while self.blocks + n_blocks > self.capacity_blocks:
            old_rid, (_, old_blocks) = next(iter(self._entries.items()))
            del self._entries[old_rid]
            self.blocks -= old_blocks
            self.evicted += 1
            self._publish(old_rid, None)
        self._entries[request_id] = (entry, n_blocks)
        self.blocks += n_blocks
        self.parked += 1
        self._publish(request_id, entry)
        return True

    def unpark(self, request_id: str) -> Any | None:
        """Take a parked entry out (resume path); None when absent/evicted.
        Falls back to the store copy when another replica parked it (this
        pool instance never saw the park but the object is on the shared
        pool) — tombstones read as absent."""
        got = self._entries.pop(request_id, None)
        if got is not None:
            entry, n_blocks = got
            self.blocks -= n_blocks
            self.unparked += 1
            self._publish(request_id, None)
            return entry
        if self.store is not None:
            obj = self.store.get(f"{self.prefix}/{request_id}")
            if obj is not None and obj.payload is not None:
                self.unparked += 1
                self._publish(request_id, None)
                return obj.payload
        return None

    def discard(self, request_id: str) -> None:
        """Drop a parked entry without resuming (request completed via
        replay, expired, or failed)."""
        got = self._entries.pop(request_id, None)
        if got is not None:
            self.blocks -= got[1]
            self._publish(request_id, None)

    def has(self, request_id: str) -> bool:
        return request_id in self._entries

    def stats(self) -> dict[str, int]:
        return {"spill_pool_blocks": self.blocks,
                "spill_pool_parked": self.parked,
                "spill_pool_unparked": self.unparked,
                "spill_pool_evicted": self.evicted}
