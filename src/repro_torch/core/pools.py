"""Object pools (§3.2): path prefix + persistence + replication + sharding.

(Copied from the JAX package's ``core/pools.py``, whose package
``__init__`` imports jax.)

Objects are managed in pools identified by a path prefix.  Each pool carries
an access-control policy, a replication factor, persistence properties, and a
sharding policy.  Cascade offers three persistence levels:

- ``TRANSIENT``  — trigger-put targets: the object initiates a lambda and
  vanishes (never stored, never replicated);
- ``VOLATILE``   — the latest version of each key is retained in memory on
  every member of the key's home shard;
- ``PERSISTENT`` — every version is retained in memory metadata *and* logged
  to persistent storage with backpointer chains + a temporal index.
"""
from __future__ import annotations

import enum
import zlib
from dataclasses import dataclass, field
from typing import Callable

from .trie import split_path


class Persistence(enum.Enum):
    TRANSIENT = "transient"
    VOLATILE = "volatile"
    PERSISTENT = "persistent"


class DispatchPolicy(enum.Enum):
    """Upcall dispatch (§3.3): round-robin load balancing, or FIFO-by-key
    (objects sharing a key always run on the same upcall thread)."""

    ROUND_ROBIN = "rr"
    FIFO = "fifo"


def default_shard_hash(key: str) -> int:
    """Deterministic key→shard hash (§3.5). crc32 is stable across runs —
    required so that home shards survive restarts (unlike ``hash()``)."""
    return zlib.crc32(key.encode())


def affinity_shard_hash(key: str, depth: int = 2) -> int:
    """Customized grouping hash (§3.2: 'a hashing scheme that can be
    customized to group objects so that related objects will always be
    hosted on the same nodes').  Hashes only the first ``depth`` path
    components below the pool, so e.g. all objects of one camera/session
    share a home shard."""
    comps = split_path(key)
    return zlib.crc32("/".join(comps[:depth]).encode())


@dataclass(frozen=True)
class PoolSpec:
    path: str                               # pool path prefix, e.g. "/sf/detect_animal"
    persistence: Persistence = Persistence.VOLATILE
    replication: int = 1                    # shard size (number of members)
    shard_hash: Callable[[str], int] = default_shard_hash
    dispatch: DispatchPolicy = DispatchPolicy.ROUND_ROBIN
    # device-store placement (used by devstore): logical axes for payload
    # sharding; None = replicate within the home slice.
    device_axes: tuple[str | None, ...] | None = None
    readers: frozenset[str] = frozenset()   # access-control policy (empty = open)
    writers: frozenset[str] = frozenset()

    def __post_init__(self) -> None:
        if not self.path.startswith("/"):
            raise ValueError(f"pool path must be absolute, got {self.path!r}")
        if self.replication < 1:
            raise ValueError("replication factor must be >= 1")

    def owns(self, key: str) -> bool:
        pc = split_path(self.path)
        kc = split_path(key)
        return kc[: len(pc)] == pc

    def can_read(self, principal: str) -> bool:
        return not self.readers or principal in self.readers

    def can_write(self, principal: str) -> bool:
        return not self.writers or principal in self.writers


@dataclass
class PoolRegistry:
    """Pool lookup by longest path-prefix.  Although pool paths permit a
    hierarchical organization, any given object resides in a single pool —
    the deepest registered prefix wins (§3.2)."""

    _pools: dict[str, PoolSpec] = field(default_factory=dict)

    def create(self, spec: PoolSpec) -> PoolSpec:
        if spec.path in self._pools:
            raise ValueError(f"pool {spec.path} already exists")
        self._pools[spec.path] = spec
        return spec

    def remove(self, path: str) -> PoolSpec:
        """Drop a pool from the registry (deployment teardown).  Returns the
        removed spec so callers can clean up per-pool state (shard maps,
        sequencers, stored keys) keyed off it."""
        spec = self._pools.pop(path, None)
        if spec is None:
            raise KeyError(f"no pool registered at {path!r}")
        return spec

    def __contains__(self, path: str) -> bool:
        return path in self._pools

    def lookup(self, key: str) -> PoolSpec | None:
        """Deepest pool whose path is a prefix of ``key``."""
        comps = split_path(key)
        for depth in range(len(comps), 0, -1):
            p = "/" + "/".join(comps[:depth])
            spec = self._pools.get(p)
            if spec is not None:
                return spec
        return None

    def get(self, path: str) -> PoolSpec:
        return self._pools[path]

    def __iter__(self):
        return iter(self._pools.values())

    def __len__(self) -> int:
        return len(self._pools)
