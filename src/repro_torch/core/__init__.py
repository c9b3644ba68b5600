"""Host-side core of the port: objects, versioning, the persistent log,
pools, placement, the dispatcher, the store with its ``SpillPool``, the
path trie, the DFG, the lambda API, ``CascadeService`` and the broker
baseline, copied from the JAX package's plain-Python modules (whose package
``__init__`` imports jax), a torch ``DeviceStore`` and the device fast path
(``fastpath``: fused stages as one CUDA graph, chained stages, the
device-to-device handoff and the broker hop it is measured against)."""
from .baseline import Broker, BrokerPipeline
from .devstore import DeviceStore
from .dfg import DFG, Vertex
from .dispatcher import Dispatcher, LambdaHandle, UpcallEvent, UpcallThreadPool
from .fastpath import (FastPathPipeline, Stage, broker_hop, chain_stages,
                       fuse_stages, handoff)
from .lambda_api import CascadeContext, wrap_lambda
from .log import PersistentLog
from .objects import INVALID_VERSION, CascadeObject
from .placement import LRUCache, RoundRobin, ShardMap, build_shard_map
from .pools import DispatchPolicy, Persistence, PoolRegistry, PoolSpec, affinity_shard_hash, default_shard_hash
from .service import CascadeService
from .store import CascadeStore, PutReceipt, Worker
from .trie import PathTrie
from .versioning import SeqlockCell, VersionChain

__all__ = [
    "Broker", "BrokerPipeline", "DeviceStore", "DFG", "Vertex", "Dispatcher",
    "FastPathPipeline", "Stage", "broker_hop", "chain_stages", "fuse_stages",
    "handoff",
    "LambdaHandle", "UpcallEvent", "UpcallThreadPool", "CascadeContext",
    "wrap_lambda", "PersistentLog", "INVALID_VERSION", "CascadeObject",
    "LRUCache", "RoundRobin", "ShardMap", "build_shard_map",
    "DispatchPolicy", "Persistence", "PoolRegistry", "PoolSpec",
    "affinity_shard_hash", "default_shard_hash", "CascadeService",
    "CascadeStore", "PutReceipt", "Worker", "PathTrie", "SeqlockCell",
    "VersionChain",
]
