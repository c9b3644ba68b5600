"""Lock-free versioned object cells and per-key version chains (§3.2, §3.6).

(Copied from the JAX package's ``core/versioning.py``, whose package
``__init__`` imports jax.)

The paper avoids a get/put lock with two atomic version numbers per object:

    put:  v_a += 1 ; write data ; v_b = v_a
    get:  read v_b ; read data ; re-read v_a ; retry if v_a != v_b

CPython guarantees that attribute loads/stores of ints are atomic w.r.t. the
GIL, so the seqlock below is a faithful functional port: a get that races a
put observes ``v_a != v_b`` and retries, and torn payload reads are detected
exactly as in the paper.  ``VersionChain`` keeps the backpointer-linked
version history used by the persistent pools' range/temporal queries.
"""
from __future__ import annotations

import bisect
import threading
from typing import Any, Iterator

from .objects import INVALID_VERSION, CascadeObject, monotonic_ns


class SeqlockCell:
    """One key's current value, readable without locks while puts proceed."""

    __slots__ = ("_va", "_vb", "_obj")

    def __init__(self) -> None:
        self._va = 0
        self._vb = 0
        self._obj: CascadeObject | None = None

    def store(self, obj: CascadeObject) -> None:
        # Writers are serialized upstream (Cascade runs puts on a single
        # system thread per shard member); gets run on other threads.
        self._va += 1
        self._obj = obj
        self._vb = self._va

    def load(self) -> CascadeObject | None:
        while True:
            vb = self._vb
            obj = self._obj
            va = self._va
            if va == vb:
                return obj
            # torn read: a put was in flight — reissue (paper §3.2)


class VersionChain:
    """All versions of one key, linked by backpointers, temporally indexed.

    ``versions`` is append-only and sorted by construction (versions are
    assigned monotonically per shard), so version/time range queries are a
    bisect + walk over the backpointer chain — the same data structures the
    paper describes for its persisted log (§3.6), held here in memory for the
    volatile store as well.
    """

    __slots__ = ("_objs", "_versions", "_timestamps", "_cell", "lock")

    def __init__(self) -> None:
        self._objs: list[CascadeObject] = []
        self._versions: list[int] = []
        self._timestamps: list[int] = []
        self._cell = SeqlockCell()
        self.lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._objs)

    @property
    def latest_version(self) -> int:
        return self._versions[-1] if self._versions else INVALID_VERSION

    def append(self, obj: CascadeObject, version: int,
               ts_ns: int | None = None) -> CascadeObject:
        """Version the object, link the backpointer, publish via seqlock.

        ``ts_ns``: the platform timestamp assigned at put time; replicas must
        all record the same one so temporal gets agree across members."""
        with self.lock:
            prev = self.latest_version
            stamped = obj.with_version(
                version, prev,
                ts_ns=(obj.timestamp_ns or monotonic_ns()) if ts_ns is None else ts_ns)
            self._objs.append(stamped)
            self._versions.append(version)
            self._timestamps.append(stamped.timestamp_ns)
            self._cell.store(stamped)
            return stamped

    def latest(self) -> CascadeObject | None:
        return self._cell.load()

    def at_version(self, version: int) -> CascadeObject | None:
        """Newest version ≤ ``version`` (paper: versioned get)."""
        i = bisect.bisect_right(self._versions, version)
        return self._objs[i - 1] if i else None

    def at_time(self, ts_ns: int) -> CascadeObject | None:
        """Temporal get: newest version with timestamp ≤ ``ts_ns`` (§3.6)."""
        i = bisect.bisect_right(self._timestamps, ts_ns)
        return self._objs[i - 1] if i else None

    def version_range(self, lo: int, hi: int) -> list[CascadeObject]:
        """Versions in [lo, hi], extracted by walking the backpointer chain."""
        i = bisect.bisect_right(self._versions, hi)
        if i == 0:
            return []
        out: list[CascadeObject] = []
        # Walk backpointers from the newest in-range version (paper §3.6:
        # "scanning the linked version chain to extract a series of pointers").
        idx = i - 1
        by_version = {v: j for j, v in enumerate(self._versions)}
        cur = self._objs[idx]
        while cur is not None and cur.version >= lo:
            out.append(cur)
            pv = cur.previous_version
            cur = self._objs[by_version[pv]] if pv in by_version else None
        out.reverse()
        return out

    def time_range(self, lo_ns: int, hi_ns: int) -> list[CascadeObject]:
        """Temporal range query: map the time window to a version window (§3.6)."""
        lo_i = bisect.bisect_left(self._timestamps, lo_ns)
        hi_i = bisect.bisect_right(self._timestamps, hi_ns)
        if lo_i >= hi_i:
            return []
        return self.version_range(self._versions[lo_i], self._versions[hi_i - 1])

    def __iter__(self) -> Iterator[CascadeObject]:
        return iter(list(self._objs))
