"""Persistent versioned log (§3.2 persistent pools, §3.6 optimizations).

(Copied from the JAX package's ``core/log.py``, whose package
``__init__`` imports jax.)

Faithful to the paper's three accelerations:

1. **Memory-mapped log files** — reads go through an ``mmap`` view of the
   log file, giving a simplified read path (no seek/read syscalls per get).
2. **Asynchronous write-back** — a write-back thread flushes opportunistically
   *batched* updates: while a put is only acknowledged as *stable* once its
   bytes are durable, many queued records are written with a single
   ``write``+``flush`` pair, exactly the paper's ad-hoc mini-batching.
3. **Backpointer chains** — each record stores the file offset of the
   previous record *of the same key*, so version-range queries walk the chain
   backwards without scanning; a temporally-sorted secondary index maps time
   windows to version windows.

Stable-prefix rule: temporal reads whose window extends past the stability
frontier ("into the future") block until the frontier covers them, so a
window can never silently omit a version (§3.6).

Record layout (little-endian):
    u32 magic | u64 version | u64 prev_offset | i64 timestamp_ns
    u32 keylen | u32 payloadlen | key bytes | payload bytes
"""
from __future__ import annotations

import mmap
import os
import struct
import threading
from dataclasses import dataclass
from typing import Iterator

from .objects import INVALID_VERSION, CascadeObject, monotonic_ns
from .versioning import VersionChain

_MAGIC = 0xCA5CADE0
_HEADER = struct.Struct("<IQQqII")
_NO_PREV = 0xFFFFFFFFFFFFFFFF


@dataclass
class _PendingRecord:
    key: str
    payload: bytes
    version: int
    timestamp_ns: int
    done: threading.Event


class PersistentLog:
    """One shard member's persisted log for a persistent pool."""

    def __init__(self, path: str, flush_interval_s: float = 0.0005) -> None:
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._file = open(path, "ab+")
        self._file.seek(0, os.SEEK_END)
        self._tail = self._file.tell()          # next write offset
        self._stable_frontier_ns = monotonic_ns()
        self._stable_version = INVALID_VERSION
        # In-memory metadata cached for all active objects (§3.6): per-key
        # chain of (version, ts, file offset) plus the latest payload.
        self._chains: dict[str, VersionChain] = {}
        self._offsets: dict[tuple[str, int], int] = {}
        self._last_offset: dict[str, int] = {}
        self._next_version = 0
        self._meta_lock = threading.Lock()
        # Write-back machinery.
        self._queue: list[_PendingRecord] = []
        self._queue_lock = threading.Lock()
        self._queue_cv = threading.Condition(self._queue_lock)
        self._flush_interval_s = flush_interval_s
        self._pending = 0                       # queued or mid-flush records
        self._pending_zero = threading.Event()
        self._pending_zero.set()
        self._closed = False
        self._mmap: mmap.mmap | None = None
        self._mmap_size = 0
        self.flush_batches = 0
        self.flushed_records = 0
        self._writer = threading.Thread(target=self._write_back_loop, daemon=True)
        self._writer.start()
        if self._tail:
            self._recover()

    # ------------------------------------------------------------- put path
    def append(self, key: str, payload: bytes, *, wait_stable: bool = True,
               ts_ns: int | None = None) -> CascadeObject:
        """Log a new version of ``key``.  Returns the stamped object.

        In-memory state is updated atomically first (Derecho-style: the
        in-memory copy and backpointer metadata update need no disk I/O),
        then the record is queued for the write-back thread; if
        ``wait_stable`` the call returns only after the bytes are durable —
        this is the paper's persistent-put acknowledgement point.
        """
        obj, done = self.append_nowait(key, payload, ts_ns=ts_ns)
        if wait_stable:
            done.wait()
        return obj

    def append_nowait(self, key: str, payload: bytes, *, ts_ns: int | None = None
                      ) -> tuple[CascadeObject, threading.Event]:
        """Queue a record and return (stamped object, its OWN stability
        event), so a caller can await this record's durability without
        waiting for the whole queue to drain (other writers' records).

        Version stamping and enqueueing happen under ONE critical section:
        otherwise a preempted writer could enqueue a higher version first,
        writing the log out of version order and regressing the stability
        frontier.  (The write-back thread never holds _queue_cv while taking
        _meta_lock, so this nesting cannot deadlock.)
        """
        with self._meta_lock:
            version = self._next_version
            self._next_version += 1
            chain = self._chains.get(key)
            if chain is None:
                chain = self._chains[key] = VersionChain()
            obj = chain.append(CascadeObject(key=key, payload=payload), version,
                               ts_ns=ts_ns)
            rec = _PendingRecord(key, payload, version, obj.timestamp_ns,
                                 threading.Event())
            with self._queue_cv:
                self._queue.append(rec)
                self._pending += 1
                self._pending_zero.clear()
                self._queue_cv.notify()
        return obj, rec.done

    def _write_back_loop(self) -> None:
        while True:
            with self._queue_cv:
                while not self._queue and not self._closed:
                    self._queue_cv.wait(timeout=self._flush_interval_s)
                batch, self._queue = self._queue, []
                if self._closed and not batch:
                    return
            if not batch:
                continue
            # Opportunistic batching: one write+flush for the whole backlog.
            buf = bytearray()
            offsets: list[int] = []
            base = self._tail
            with self._meta_lock:  # _last_offset is shared with get()/_recover
                for rec in batch:
                    off = base + len(buf)
                    offsets.append(off)
                    prev = self._last_offset.get(rec.key, _NO_PREV)
                    kb = rec.key.encode()
                    buf += _HEADER.pack(_MAGIC, rec.version, prev,
                                        rec.timestamp_ns,
                                        len(kb), len(rec.payload))
                    buf += kb
                    buf += rec.payload
                    self._last_offset[rec.key] = off
            self._file.write(buf)
            self._file.flush()
            os.fsync(self._file.fileno())
            self._tail = base + len(buf)
            with self._meta_lock:
                for rec, off in zip(batch, offsets):
                    self._offsets[(rec.key, rec.version)] = off
                self._stable_version = batch[-1].version
                self._stable_frontier_ns = batch[-1].timestamp_ns
            self.flush_batches += 1
            self.flushed_records += len(batch)
            for rec in batch:
                rec.done.set()
            with self._queue_cv:
                self._pending -= len(batch)
                if self._pending == 0:
                    self._pending_zero.set()

    # ------------------------------------------------------------- get path
    def _view(self) -> mmap.mmap:
        """(Re-)mmap the log file if it has grown — the read path (§3.6)."""
        size = self._tail
        if self._mmap is None or self._mmap_size < size:
            if self._mmap is not None:
                self._mmap.close()
            self._mmap = mmap.mmap(self._file.fileno(), size, access=mmap.ACCESS_READ)
            self._mmap_size = size
        return self._mmap

    def _read_at(self, offset: int) -> tuple[CascadeObject, int]:
        m = self._view()
        magic, version, prev, ts, klen, plen = _HEADER.unpack_from(m, offset)
        if magic != _MAGIC:
            raise IOError(f"corrupt log record at {offset}")
        ko = offset + _HEADER.size
        key = bytes(m[ko : ko + klen]).decode()
        payload = bytes(m[ko + klen : ko + klen + plen])
        prev_off = -1 if prev == _NO_PREV else prev
        return (
            CascadeObject(key=key, payload=payload, version=version,
                          timestamp_ns=ts, previous_version=prev_off),
            prev_off,
        )

    def latest(self, key: str) -> CascadeObject | None:
        chain = self._chains.get(key)
        return chain.latest() if chain else None

    def get_version(self, key: str, version: int) -> CascadeObject | None:
        chain = self._chains.get(key)
        return chain.at_version(version) if chain else None

    def get_time(self, key: str, ts_ns: int, *, timeout_s: float = 5.0) -> CascadeObject | None:
        """Temporal get.  Blocks while ts_ns is past the stability frontier."""
        self.wait_stable(ts_ns, timeout_s=timeout_s)
        chain = self._chains.get(key)
        return chain.at_time(ts_ns) if chain else None

    def flush(self, timeout_s: float = 5.0) -> None:
        """Block until every queued record is durable."""
        if not self._pending_zero.wait(timeout_s):
            raise TimeoutError("write-back did not drain")

    def version_range_from_disk(self, key: str, lo: int, hi: int) -> list[CascadeObject]:
        """Range query answered from the *log file* by walking backpointers."""
        self.flush()
        off = self._last_offset.get(key)
        if off is None:
            return []
        # Skip forward-of-range by jumping down the chain.
        out: list[CascadeObject] = []
        cur = off
        while cur != -1 and cur != _NO_PREV:
            obj, prev = self._read_at(cur)
            if obj.version < lo:
                break
            if obj.version <= hi:
                out.append(obj)
            cur = prev
        out.reverse()
        return out

    def time_range(self, key: str, lo_ns: int, hi_ns: int, *, timeout_s: float = 5.0) -> list[CascadeObject]:
        """Map the time window to a version window, then range-query (§3.6)."""
        self.wait_stable(hi_ns, timeout_s=timeout_s)
        chain = self._chains.get(key)
        if chain is None:
            return []
        objs = chain.time_range(lo_ns, hi_ns)
        if not objs:
            return []
        return self.version_range_from_disk(key, objs[0].version, objs[-1].version)

    def wait_stable(self, ts_ns: int, *, timeout_s: float = 5.0) -> None:
        """Block until the stability frontier passes ``ts_ns`` (§3.6)."""
        deadline = monotonic_ns() + int(timeout_s * 1e9)
        while self._stable_frontier_ns < ts_ns:
            with self._queue_lock:
                backlog = bool(self._queue)
            if not backlog and monotonic_ns() >= ts_ns:
                # Nothing pending and wall clock passed the window: frontier
                # advances to 'now' (no version can be stamped before it).
                with self._meta_lock:
                    self._stable_frontier_ns = max(self._stable_frontier_ns, ts_ns)
                return
            if monotonic_ns() > deadline:
                raise TimeoutError("stability frontier did not advance")
            threading.Event().wait(0.0002)

    # ------------------------------------------------------------- recovery
    def _recover(self) -> None:
        """Rebuild in-memory metadata by a single forward scan (restart)."""
        off = 0
        records: list[tuple[int, CascadeObject]] = []
        while off < self._tail:
            obj, _ = self._read_at(off)
            records.append((off, obj))
            off += _HEADER.size + len(obj.key.encode()) + len(obj.payload)
        with self._meta_lock:
            for off, obj in records:
                chain = self._chains.get(obj.key)
                if chain is None:
                    chain = self._chains[obj.key] = VersionChain()
                chain.append(CascadeObject(key=obj.key, payload=obj.payload), obj.version)
                self._offsets[(obj.key, obj.version)] = off
                self._last_offset[obj.key] = off
                self._next_version = max(self._next_version, obj.version + 1)
                self._stable_version = obj.version

    def keys(self) -> Iterator[str]:
        return iter(list(self._chains.keys()))

    def close(self) -> None:
        with self._queue_cv:
            self._closed = True
            self._queue_cv.notify()
        self._writer.join(timeout=5)
        if self._mmap is not None:
            self._mmap.close()
            self._mmap = None
        self._file.close()
