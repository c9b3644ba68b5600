"""Device-resident object store (§3.2 + §3.5), on one torch device.

Port of the JAX package's ``core/devstore.py``.  The host-side
``CascadeStore`` moves references and small metadata; tensors live here.
A store owns one device (``device``, the card by default); a key may pin
another single device with ``register_sharding``.  Placements over several
devices (the reference's ``PartitionSpec`` over a mesh) come with the mesh
slice of the port.

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
from typing import Any, Callable

import numpy as np
import torch

from .objects import monotonic_ns
from .placement import LRUCache
from .pools import Persistence, PoolRegistry, PoolSpec


@dataclass
class _DevEntry:
    versions: OrderedDict[int, Any] = field(default_factory=OrderedDict)
    timestamps: dict[int, int] = field(default_factory=dict)
    latest: int = -1


def _map(value: Any, fn: Callable[[Any], Any]) -> Any:
    """``value`` with ``fn`` applied to every leaf (lists, tuples and dicts
    are the inner nodes)."""
    if isinstance(value, dict):
        return {k: _map(v, fn) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_map(v, fn) for v in value)
    return fn(value)


def _leaves(value: Any) -> list:
    out: list = []
    _map(value, out.append)
    return out


def _tree_nbytes(value: Any) -> int:
    return sum(leaf.numel() * leaf.element_size()
               if isinstance(leaf, torch.Tensor)
               else int(getattr(leaf, "nbytes", 0))
               for leaf in _leaves(value))


def _tree_placed(value: Any, device: torch.device) -> bool:
    """True iff every leaf is already a tensor on ``device``."""
    leaves = _leaves(value)
    return bool(leaves) and all(
        isinstance(leaf, torch.Tensor) and leaf.device == device
        for leaf in leaves)


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    """A host copy; bf16 and fp8 (which numpy lacks) as exact f32."""
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

    def register_sharding(self, key: str, device) -> None:
        """Pin ``key`` to one device (a ``torch.device`` or its name): its
        donate check and its copies use that device instead of the
        store's.  A placement over several devices raises until the mesh
        slice of the port."""
        if isinstance(device, (list, tuple, dict)):
            from repro_torch.serving.engine import _later
            raise _later("mesh slices", "mesh")
        dev = resolve_device(device, "DeviceStore")
        with self._lock:
            self._devices[key] = dev

    def sharding_for(self, key: str) -> torch.device:
        """The device the values under ``key`` live on."""
        return self._devices.get(key, self.device)

    # -- puts -----------------------------------------------------------------
    def put(self, key: str, value: Any, *, donate: bool = False) -> Any:
        """Place ``value`` on the key's device and version it.

        ``donate``: if every leaf is already a tensor on that device,
        install the references without any copy (fast-path put)."""
        spec = self.pools.lookup(key)
        if spec is None:
            raise KeyError(f"no device pool owns {key!r}")
        dst = self.sharding_for(key)
        if donate and _tree_placed(value, dst):
            arr = value
            with self._lock:
                self.donate_hits += 1
        else:
            arr = _map(value, lambda leaf: torch.as_tensor(leaf).to(
                dst, copy=True))
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
                    out[key] = _map(arr, _to_numpy)
        return out
