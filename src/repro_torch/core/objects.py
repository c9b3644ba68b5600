"""Cascade objects: keyed, versioned, timestamped payloads (§3.2).

(Copied from the JAX package's ``core/objects.py``, whose package
``__init__`` imports jax.)

A ``CascadeObject`` is the unit the K/V store moves: a key (a ``/`` path whose
first components name the object pool), a payload, a monotonically-increasing
per-key version, a platform-assigned timestamp, and a backpointer to the
previous version of the same key (§3.6 — backpointer chains accelerate
version/temporal range queries).

Payloads may be ``bytes``, numpy arrays, or JAX arrays; on the device fast
path objects carry device arrays and the host only moves *references* —
mirroring the paper's zero-copy discipline.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

INVALID_VERSION = -1


def monotonic_ns() -> int:
    return time.monotonic_ns()


@dataclass(frozen=True)
class CascadeObject:
    key: str
    payload: Any
    version: int = INVALID_VERSION
    timestamp_ns: int = 0
    previous_version: int = INVALID_VERSION  # backpointer (§3.6)
    meta: dict[str, Any] = field(default_factory=dict)

    @property
    def pool_path(self) -> str:
        """Pool prefix = first path component (pools may register deeper)."""
        comps = [c for c in self.key.split("/") if c]
        return "/" + comps[0] if comps else "/"

    def with_version(self, version: int, previous: int, ts_ns: int | None = None) -> "CascadeObject":
        if ts_ns is None:
            ts_ns = self.timestamp_ns or monotonic_ns()
        return CascadeObject(
            key=self.key,
            payload=self.payload,
            version=version,
            timestamp_ns=ts_ns,
            previous_version=previous,
            meta=self.meta,
        )

    def nbytes(self) -> int:
        p = self.payload
        if p is None:
            return 0
        if isinstance(p, (bytes, bytearray, memoryview)):
            return len(p)
        nb = getattr(p, "nbytes", None)
        if nb is not None:
            return int(nb)
        return len(repr(p))
