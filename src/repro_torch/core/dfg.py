"""Data-flow graphs of ML stages (§3.1).

(Copied from the JAX package's ``core/dfg.py``, whose package
``__init__`` imports jax.)

An application is a DFG: vertices are lambdas bound to path prefixes, edges
are the object flows between them.  A JSON file describing the DFG is
uploaded to Cascade; here ``DFG.from_json`` accepts exactly that shape:

    {
      "name": "smart_farming",
      "vertices": [
        {"name": "filter", "prefix": "/sf/detect_animal",
         "pool": {"persistence": "volatile", "replication": 1},
         "dispatch": "rr", "shard_workers": [0]},
        ...
      ],
      "edges": [["filter", "bcs"], ["bcs", "store"]]
    }
"""
from __future__ import annotations

import json
from bisect import insort
from dataclasses import dataclass, field
from typing import Iterable

from .pools import DispatchPolicy, Persistence, PoolSpec

_PERSISTENCE = {p.value: p for p in Persistence}
_DISPATCH = {"rr": DispatchPolicy.ROUND_ROBIN, "fifo": DispatchPolicy.FIFO}


@dataclass(frozen=True)
class Vertex:
    name: str
    prefix: str
    persistence: Persistence = Persistence.VOLATILE
    replication: int = 1
    dispatch: DispatchPolicy = DispatchPolicy.ROUND_ROBIN
    shard_workers: tuple[int, ...] | None = None  # None = all workers

    def pool_spec(self) -> PoolSpec:
        return PoolSpec(path=self.prefix, persistence=self.persistence,
                        replication=self.replication, dispatch=self.dispatch)


@dataclass
class DFG:
    name: str
    vertices: dict[str, Vertex] = field(default_factory=dict)
    edges: list[tuple[str, str]] = field(default_factory=list)

    def add_vertex(self, v: Vertex) -> Vertex:
        if v.name in self.vertices:
            raise ValueError(f"duplicate vertex {v.name}")
        self.vertices[v.name] = v
        return v

    def add_edge(self, src: str, dst: str) -> None:
        for n in (src, dst):
            if n not in self.vertices:
                raise ValueError(f"unknown vertex {n}")
        self.edges.append((src, dst))

    def successors(self, name: str) -> list[Vertex]:
        return [self.vertices[d] for s, d in self.edges if s == name]

    def sources(self) -> list[Vertex]:
        has_in = {d for _, d in self.edges}
        return [v for v in self.vertices.values() if v.name not in has_in]

    def sinks(self) -> list[Vertex]:
        has_out = {s for s, _ in self.edges}
        return [v for v in self.vertices.values() if v.name not in has_out]

    def validate(self) -> None:
        # prefixes must be unique and acyclic flow
        prefixes = [v.prefix for v in self.vertices.values()]
        if len(set(prefixes)) != len(prefixes):
            raise ValueError("vertex path prefixes must be unique")
        # Kahn's algorithm for cycle detection.
        indeg = {n: 0 for n in self.vertices}
        for _, d in self.edges:
            indeg[d] += 1
        frontier = [n for n, k in indeg.items() if k == 0]
        seen = 0
        while frontier:
            n = frontier.pop()
            seen += 1
            for _, d in [(s, d) for s, d in self.edges if s == n]:
                indeg[d] -= 1
                if indeg[d] == 0:
                    frontier.append(d)
        if seen != len(self.vertices):
            raise ValueError(f"DFG {self.name} has a cycle")

    def topo_order(self) -> list[Vertex]:
        """Deterministic Kahn order: the frontier is kept sorted, so vertices
        with equal indegree come out lexicographically regardless of the
        order vertices/edges were added (deployments must be reproducible)."""
        self.validate()
        order: list[Vertex] = []
        indeg = {n: 0 for n in self.vertices}
        for _, d in self.edges:
            indeg[d] += 1
        frontier = sorted(n for n, k in indeg.items() if k == 0)
        while frontier:
            n = frontier.pop(0)
            order.append(self.vertices[n])
            for s, d in self.edges:
                if s == n:
                    indeg[d] -= 1
                    if indeg[d] == 0:
                        insort(frontier, d)
        return order

    # -- JSON round trip -----------------------------------------------------
    @classmethod
    def from_json(cls, text: str) -> "DFG":
        doc = json.loads(text)
        dfg = cls(name=doc["name"])
        for v in doc.get("vertices", []):
            dfg.add_vertex(Vertex(
                name=v["name"],
                prefix=v["prefix"],
                persistence=_PERSISTENCE[v.get("pool", {}).get("persistence", "volatile")],
                replication=int(v.get("pool", {}).get("replication", 1)),
                dispatch=_DISPATCH[v.get("dispatch", "rr")],
                shard_workers=tuple(v["shard_workers"]) if v.get("shard_workers") else None,
            ))
        for s, d in doc.get("edges", []):
            dfg.add_edge(s, d)
        dfg.validate()
        return dfg

    def to_json(self) -> str:
        return json.dumps({
            "name": self.name,
            "vertices": [
                {
                    "name": v.name,
                    "prefix": v.prefix,
                    "pool": {"persistence": v.persistence.value, "replication": v.replication},
                    "dispatch": "fifo" if v.dispatch is DispatchPolicy.FIFO else "rr",
                    **({"shard_workers": list(v.shard_workers)} if v.shard_workers else {}),
                }
                for v in self.vertices.values()
            ],
            "edges": [list(e) for e in self.edges],
        }, indent=2)
