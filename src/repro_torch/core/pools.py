"""Dispatch policies (§3.3) — the one piece of the JAX package's
``core/pools.py`` the serving scheduler needs; object pools join with the
store slice of the port."""
from __future__ import annotations

import enum


class DispatchPolicy(enum.Enum):
    """Upcall dispatch (§3.3): round-robin load balancing, or FIFO-by-key
    (objects sharing a key always run on the same upcall thread)."""

    ROUND_ROBIN = "rr"
    FIFO = "fifo"
