"""Exception types of the serving fast path's fault handling (the JAX
package's ``serving/faults.py``); the seeded ``FaultInjector`` joins with
the cluster slice of the port."""
from __future__ import annotations


class ReplicaCrashed(RuntimeError):
    """The replica is dead: permanent until the deployment marks it down."""


class InjectedFault(RuntimeError):
    """A transient injected failure (submit/store seam): retry elsewhere."""
