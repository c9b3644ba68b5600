"""Placement: key→home-shard mapping, node selection, and the LRU cache (§3.5).

(Copied from the JAX package's ``core/placement.py``, whose package
``__init__`` imports jax.)

Cascade maps keys to shards with a deterministic hash; within a shard, a
round-robin policy picks the member that processes each matching object, so
tasks land on nodes that already hold the required model weights.  An LRU
cache retains secondarily-accessed objects: after a short warm-up all shard
members hold copies of systematically-required data.
"""
from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from .pools import PoolSpec


@dataclass(frozen=True)
class ShardMap:
    """Static membership: which workers back each shard of a pool."""

    pool: str
    shards: tuple[tuple[int, ...], ...]  # shards[i] = worker ids of shard i

    def home_shard(self, spec: PoolSpec, key: str) -> int:
        return spec.shard_hash(key) % len(self.shards)

    def members(self, spec: PoolSpec, key: str) -> tuple[int, ...]:
        return self.shards[self.home_shard(spec, key)]


class RoundRobin:
    """Per-shard round-robin member selection (thread-safe)."""

    def __init__(self) -> None:
        self._counters: dict[Any, itertools.count] = {}
        self._lock = threading.Lock()

    def pick(self, group_key: Any, members: Sequence[int]) -> int:
        with self._lock:
            ctr = self._counters.get(group_key)
            if ctr is None:
                ctr = self._counters[group_key] = itertools.count()
            return members[next(ctr) % len(members)]


class LRUCache:
    """Byte-budgeted LRU of CascadeObjects (§3.5)."""

    def __init__(self, capacity_bytes: int) -> None:
        self.capacity_bytes = capacity_bytes
        self._items: OrderedDict[str, tuple[Any, int]] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Any | None:
        with self._lock:
            entry = self._items.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._items.move_to_end(key)
            self.hits += 1
            return entry[0]

    def put(self, key: str, value: Any, nbytes: int) -> None:
        with self._lock:
            old = self._items.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._items[key] = (value, nbytes)
            self._bytes += nbytes
            while self._bytes > self.capacity_bytes and len(self._items) > 1:
                _, (_, nb) = self._items.popitem(last=False)
                self._bytes -= nb

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._items

    def __len__(self) -> int:
        return len(self._items)

    @property
    def nbytes(self) -> int:
        return self._bytes


def build_shard_map(pool: str, worker_ids: Sequence[int], replication: int) -> ShardMap:
    """Partition workers into shards of ``replication`` members each.

    len(worker_ids) must be a multiple of replication; each worker serves
    exactly one shard of this pool (matching the paper's deployments where
    each stage's pool is backed by a dedicated shard of 1..5 servers).
    """
    ids = list(worker_ids)
    if replication > len(ids):
        raise ValueError(f"pool {pool}: replication {replication} > workers {len(ids)}")
    n_shards = len(ids) // replication
    shards = tuple(
        tuple(ids[i * replication : (i + 1) * replication]) for i in range(n_shards)
    )
    return ShardMap(pool=pool, shards=shards)
