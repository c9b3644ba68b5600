"""The lambda API (§3.1): how hosted application logic talks to Cascade.

(Copied from the JAX package's ``core/lambda_api.py``, whose package
``__init__`` imports jax.)

A lambda is a callable ``fn(ctx, obj) -> result``.  The wrapper a developer
writes has two responsibilities (paper): provide an upcallable function, and
use the SDK to read inputs / write outputs.  ``CascadeContext`` is that SDK:
get/put/trigger_put against the service store plus ``emit`` which forwards a
result along the DFG edge(s) — the idiom every staged application uses.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from .dfg import DFG, Vertex
from .dispatcher import LambdaHandle
from .objects import CascadeObject
from .pools import DispatchPolicy
from .store import CascadeStore, PutReceipt

LambdaFn = Callable[["CascadeContext", CascadeObject], Any]


@dataclass
class CascadeContext:
    store: CascadeStore
    dfg: DFG | None = None
    vertex: Vertex | None = None
    worker_id: int = -1

    # -- SDK surface ---------------------------------------------------------
    def get(self, key: str) -> CascadeObject | None:
        return self.store.get(key)

    def get_time(self, key: str, ts_ns: int) -> CascadeObject | None:
        return self.store.get_time(key, ts_ns)

    def put(self, key: str, payload: Any) -> PutReceipt:
        return self.store.put(key, payload)

    def trigger_put(self, key: str, payload: Any) -> PutReceipt:
        return self.store.trigger_put(key, payload)

    def emit(self, suffix: str, payload: Any, *, trigger: bool = False) -> list[PutReceipt]:
        """Forward a result to every successor stage of this vertex."""
        if self.dfg is None or self.vertex is None:
            raise RuntimeError("emit() requires a DFG-bound lambda")
        receipts = []
        for nxt in self.dfg.successors(self.vertex.name):
            key = f"{nxt.prefix}/{suffix}".replace("//", "/")
            if trigger:
                receipts.append(self.store.trigger_put(key, payload))
            else:
                receipts.append(self.store.put(key, payload))
        return receipts


def wrap_lambda(name: str, fn: LambdaFn, ctx: CascadeContext, vertex: Vertex) -> LambdaHandle:
    """Produce the upcallable the dispatcher invokes (thin wrapper, §3.1)."""
    bound_ctx = CascadeContext(store=ctx.store, dfg=ctx.dfg, vertex=vertex,
                               worker_id=ctx.worker_id)

    def upcall(obj: CascadeObject, _event) -> Any:
        return fn(bound_ctx, obj)

    return LambdaHandle(name=name, prefix=vertex.prefix, fn=upcall,
                        dispatch=vertex.dispatch)
