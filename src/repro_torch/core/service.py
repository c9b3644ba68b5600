"""CascadeService: a running deployment — workers + store + DFG apps (§3.1-3.3).

(Copied from the JAX package's ``core/service.py``, whose package
``__init__`` imports jax.)

``CascadeService.deploy(dfg, lambdas)`` performs the paper's "porting an
existing ML application is trivial" flow: upload the DFG (JSON or object),
then register a thin wrapper per lambda.  Pools and shard maps are created
from the DFG vertices, and each vertex's lambda is bound on the workers that
back its shard — this is the data/compute collocation: the lambda runs where
the pool's objects (and the stage's model weights) live.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from .dfg import DFG, Vertex
from .lambda_api import CascadeContext, LambdaFn, wrap_lambda
from .store import CascadeStore, PutReceipt, Worker


@dataclass
class DeployedApp:
    dfg: DFG
    handles: dict[str, Any] = field(default_factory=dict)


class CascadeService:
    def __init__(self, n_workers: int = 3, *, n_upcall_threads: int = 2,
                 log_dir: str | None = None) -> None:
        self.workers = [
            Worker(i, n_upcall_threads=n_upcall_threads,
                   log_dir=f"{log_dir}/w{i}" if log_dir else None)
            for i in range(n_workers)
        ]
        self.store = CascadeStore(self.workers)
        self.apps: dict[str, DeployedApp] = {}

    # -- deployment ------------------------------------------------------------
    def deploy(self, dfg: DFG | str, lambdas: dict[str, LambdaFn]) -> DeployedApp:
        if isinstance(dfg, str):
            dfg = DFG.from_json(dfg)
        dfg.validate()
        missing = set(dfg.vertices) - set(lambdas) - {v.name for v in dfg.sinks()
                                                      if v.name not in lambdas}
        app = DeployedApp(dfg=dfg)
        for v in dfg.topo_order():
            workers = list(v.shard_workers) if v.shard_workers is not None else None
            self.store.create_pool(v.pool_spec(), workers)
            fn = lambdas.get(v.name)
            if fn is None:
                continue  # storage-only vertex (no-op sink)
            ctx = CascadeContext(store=self.store, dfg=dfg, vertex=v)
            handle = wrap_lambda(v.name, fn, ctx, v)
            self.store.register_lambda(handle, workers)
            app.handles[v.name] = handle
        self.apps[dfg.name] = app
        return app

    # -- client API --------------------------------------------------------------
    def put(self, key: str, payload: Any) -> PutReceipt:
        return self.store.put(key, payload)

    def trigger_put(self, key: str, payload: Any) -> PutReceipt:
        return self.store.trigger_put(key, payload)

    def get(self, key: str):
        return self.store.get(key)

    def inject(self, dfg_name: str, suffix: str, payload: Any,
               *, trigger: bool = True) -> list[PutReceipt]:
        """Feed an object into every source vertex of a deployed app."""
        app = self.apps[dfg_name]
        receipts = []
        for v in app.dfg.sources():
            key = f"{v.prefix}/{suffix}".replace("//", "/")
            if trigger:
                receipts.append(self.store.trigger_put(key, payload))
            else:
                receipts.append(self.store.put(key, payload))
        return receipts

    def close(self) -> None:
        self.store.close()

    def __enter__(self) -> "CascadeService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
