"""Device-resident object store (§3.2 + §3.5), on one torch device.

Port of the JAX package's ``core/devstore.py``.  The host-side
``CascadeStore`` moves references and small metadata; tensors live here.
A store owns one device (``device``, the card by default); a key may pin
another single device, or a tree of ``core.sharded.Placement``s over a
mesh slice (a tensor-parallel replica's pool, whose leaves are
``ShardedTensor``s), with ``register_sharding``.

Versioning is functional: a put installs a value as the latest version and
retains up to ``keep_versions`` predecessors (volatile pools keep only the
latest few; persistent pools keep the whole chain).

Values are tensors or trees of them (lists, tuples and dicts: a serving
replica's paged-KV pool is a list of per-layer dicts).  ``put(...,
donate=True)`` installs a tree whose every leaf already lies on the key's
device BY REFERENCE (a donate hit: the stored leaves are the caller's
tensors, so a pool updated in place stays current and a captured CUDA graph
keeps its pointers); anything else is copied onto the device (a donate miss
when ``donate=True``).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

from .objects import monotonic_ns
from .placement import LRUCache
from .pools import Persistence, PoolRegistry, PoolSpec
from .sharded import Placement, ShardedTensor, reshard


@dataclass
class _DevEntry:
    versions: OrderedDict[int, Any] = field(default_factory=OrderedDict)
    timestamps: dict[int, int] = field(default_factory=dict)
    latest: int = -1


def _tree_nbytes(value: Any) -> int:
    return sum(leaf.numel() * leaf.element_size()
               if isinstance(leaf, torch.Tensor)
               else int(getattr(leaf, "nbytes", 0))
               for leaf in tree_leaves(value))


def _dst_leaves(dst: Any, n: int) -> list | None:
    """``dst`` (a device, a Placement, or a tree of Placements) as one
    destination per value leaf, or None when the tree is not congruent."""
    if isinstance(dst, (torch.device, Placement)):
        return [dst] * n
    leaves = tree_leaves(dst)
    return leaves if len(leaves) == n else None


def _leaf_placed(leaf: Any, dst: Any) -> bool:
    """True iff ``leaf`` already lies where ``dst`` would put it: a tensor
    on that device; a ShardedTensor of exactly that (mesh, spec); or a
    tensor on the one device of a one-device Placement (layouts cannot
    differ there)."""
    if isinstance(dst, torch.device):
        return isinstance(leaf, torch.Tensor) and leaf.device == dst
    if isinstance(leaf, ShardedTensor):
        return leaf.placement == dst
    return (isinstance(leaf, torch.Tensor) and dst.mesh.size == 1
            and leaf.device == dst.devices()[0])


def _tree_placed(value: Any, dst: Any) -> bool:
    """True iff every leaf of ``value`` already lies where ``dst`` (a
    device, a Placement, or a congruent tree of Placements) puts it."""
    leaves = tree_leaves(value)
    dsts = _dst_leaves(dst, len(leaves))
    return bool(leaves) and dsts is not None and all(
        _leaf_placed(leaf, d) for leaf, d in zip(leaves, dsts))


def _copy_to(leaf: Any, dst: Any) -> Any:
    """A copy of ``leaf`` (tensor, ShardedTensor or array) at ``dst``."""
    if isinstance(dst, Placement):
        if not isinstance(leaf, ShardedTensor):
            leaf = torch.as_tensor(leaf)
        return reshard(leaf, dst)
    if isinstance(leaf, ShardedTensor):
        return leaf.gather(dst)
    return torch.as_tensor(leaf).to(dst, copy=True)


def _to_numpy(leaf) -> np.ndarray:
    """A host copy; bf16 and fp8 (which numpy lacks) as exact f32; a
    ShardedTensor gathered whole."""
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.gather("cpu")
    t = leaf.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        t = t.float()
    return t.numpy()


def resolve_device(device, owner: str) -> torch.device:
    """``device`` as a torch.device with an index on the card; ``owner``
    (what runs there) raises when the card is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{owner} runs on the card (device='cuda') "
                               f"but CUDA is not available; pass "
                               f"device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceStore:
    def __init__(self, device="cuda", *, keep_versions: int = 2,
                 lru_bytes: int = 1 << 30) -> None:
        self.device = resolve_device(device, "DeviceStore")
        self.pools = PoolRegistry()
        self.keep_versions = keep_versions
        self.lru = LRUCache(lru_bytes)
        self._entries: dict[str, _DevEntry] = {}
        self._devices: dict[str, torch.device] = {}
        self._lock = threading.Lock()
        # donate-path accounting: hits are zero-copy reference installs,
        # misses are donate=True puts that still had to copy (a leaf off the
        # key's device) — the serving fast path's copy-free claim is
        # asserted on these
        self.donate_hits = 0
        self.donate_misses = 0

    def create_pool(self, spec: PoolSpec) -> PoolSpec:
        return self.pools.create(spec)

    def register_sharding(self, key: str, sharding) -> None:
        """Pin a per-key placement: one device (a ``torch.device`` or its
        name), one ``Placement``, or a tree of Placements congruent with
        the values put under ``key`` (a sharded replica registers its
        pool's tree here, so the donate check — and the copy fallback —
        see the slice's placements instead of the store's device)."""
        if isinstance(sharding, (str, torch.device)):
            sharding = resolve_device(sharding, "DeviceStore")
        elif not tree_leaves(sharding) or not all(
                isinstance(pl, Placement) for pl in tree_leaves(sharding)):
            raise TypeError(f"register_sharding takes a device, a Placement "
                            f"or a tree of Placements, got {sharding!r}")
        with self._lock:
            self._devices[key] = sharding

    def sharding_for(self, key: str):
        """Where the values under ``key`` live: a device, or a Placement
        (tree)."""
        return self._devices.get(key, self.device)

    # -- puts -----------------------------------------------------------------
    def put(self, key: str, value: Any, *, donate: bool = False) -> Any:
        """Place ``value`` on the key's device and version it.

        ``donate``: if every leaf already lies there (a tensor on that
        device; a ShardedTensor whose (mesh, spec) matches its registered
        Placement exactly), install the references without any copy
        (fast-path put)."""
        spec = self.pools.lookup(key)
        if spec is None:
            raise KeyError(f"no device pool owns {key!r}")
        dst = self.sharding_for(key)
        if donate and _tree_placed(value, dst):
            arr = value
            with self._lock:
                self.donate_hits += 1
        else:
            dsts = _dst_leaves(dst, len(tree_leaves(value)))
            if dsts is None:
                raise ValueError(f"the value put under {key!r} does not "
                                 f"match the tree of placements registered "
                                 f"for it")
            it = iter(dsts)
            arr = tree_map(lambda leaf: _copy_to(leaf, next(it)), value)
            if donate:
                with self._lock:
                    self.donate_misses += 1
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = _DevEntry()
            v = e.latest + 1
            e.versions[v] = arr
            e.timestamps[v] = monotonic_ns()
            e.latest = v
            keep = len(e.versions) if spec.persistence is Persistence.PERSISTENT \
                else self.keep_versions
            while len(e.versions) > keep:
                e.versions.popitem(last=False)
        return arr

    # -- gets -----------------------------------------------------------------
    def get(self, key: str, version: int | None = None) -> Any:
        e = self._entries.get(key)
        if e is None:
            return None
        if version is None:
            arr = e.versions.get(e.latest)
        else:
            # newest retained version <= requested
            cand = [v for v in e.versions if v <= version]
            arr = e.versions[max(cand)] if cand else None
        if arr is not None:
            self.lru.put(key, arr, _tree_nbytes(arr))
        return arr

    def get_time(self, key: str, ts_ns: int) -> Any:
        e = self._entries.get(key)
        if e is None:
            return None
        cand = [v for v, t in e.timestamps.items() if t <= ts_ns and v in e.versions]
        return e.versions[max(cand)] if cand else None

    def remove_prefix(self, prefix: str) -> int:
        """Drop every entry at or under the PATH ``prefix`` (deployment
        teardown).  Matching is per path component — ``/kv/light`` removes
        ``/kv/light/replica0/pool`` but never ``/kv/light2/...`` — so
        tenants with common name prefixes cannot tear each other down.
        Returns the number of keys removed.  The pool spec stays registered,
        and so does any value the read cache (``lru``) holds, as in the
        reference."""
        prefix = prefix.rstrip("/")
        removed = 0
        with self._lock:
            for key in [k for k in self._entries
                        if k == prefix or k.startswith(prefix + "/")]:
                del self._entries[key]
                removed += 1
            for key in [k for k in self._devices
                        if k == prefix or k.startswith(prefix + "/")]:
                del self._devices[key]
        return removed

    def latest_version(self, key: str) -> int:
        e = self._entries.get(key)
        return e.latest if e else -1

    def keys(self) -> list[str]:
        return list(self._entries.keys())

    def nbytes(self) -> int:
        total = 0
        for e in self._entries.values():
            for arr in e.versions.values():
                total += _tree_nbytes(arr)
        return total

    # -- export for checkpointing ------------------------------------------------
    def snapshot(self, prefix: str) -> dict[str, Any]:
        """Host-materialize the latest version of every key under prefix,
        as numpy trees of the stored structure.  numpy has no bf16 or fp8,
        so those leaves come back as their exact f32 values; every other
        dtype (f32, int8, ...) stays as stored."""
        out = {}
        for key in self.keys():
            if key.startswith(prefix):
                arr = self.get(key)
                if arr is not None:
                    out[key] = tree_map(_to_numpy, arr)
        return out
