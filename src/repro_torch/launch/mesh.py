"""Meshes of logical devices.

Port of the JAX package's ``launch/mesh.py``.  A ``Mesh`` is axis names
plus an array of ``LogicalDevice``s; a logical device is an index and the
``torch.device`` it runs on.  Every default reads ``local_devices()``,
the port's ``jax.devices()``: one logical device per visible card (one on
the CPU where there is none).  Only inside ``logical_devices(n, device)``
do *n* logical devices share one ``torch.device``: the CPU tests run a
mesh of eight on ``cpu``, and the card's smoke test a slice of two on
``cuda:0`` (the port's counterpart of
``--xla_force_host_platform_device_count``).  Disjointness (``mesh_slices``,
a serving node's free list) is by logical device.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch


@dataclass(frozen=True)
class LogicalDevice:
    index: int
    device: torch.device


class Mesh:
    """Named axes over an array of logical devices (``jax.sharding.Mesh``
    reads the same two attributes: ``axis_names`` and ``devices``)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self._key = (self.axis_names, devices.shape, tuple(devices.flat))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def torch_devices(self) -> list[torch.device]:
        """The distinct torch devices under the mesh, in mesh order."""
        out: list[torch.device] = []
        for ld in self.devices.flat:
            if ld.device not in out:
                out.append(ld.device)
        return out

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)


_override = threading.local()


def _card_devices() -> list[torch.device]:
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def local_devices() -> list[LogicalDevice]:
    """The logical devices every default reads: one per visible card (one
    on the CPU without a card), or those of the innermost
    ``logical_devices`` scope of this thread."""
    forced = getattr(_override, "devices", None)
    if forced is not None:
        return list(forced)
    return [LogicalDevice(i, d) for i, d in enumerate(_card_devices())]


@contextlib.contextmanager
def logical_devices(n: int, device="cpu") -> Iterator[list[LogicalDevice]]:
    """Inside the block, ``local_devices()`` gives ``n`` logical devices on
    the one ``torch.device`` ``device``.  Nothing else maps several logical
    devices onto one device."""
    if n <= 0:
        raise ValueError(f"need n > 0 logical devices, got {n}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    devs = [LogicalDevice(i, dev) for i in range(n)]
    prev = getattr(_override, "devices", None)
    _override.devices = devs
    try:
        yield devs
    finally:
        _override.devices = prev


def device_mesh(device) -> Mesh:
    """A (data=1, model=1) slice of one logical device on ``device``: what
    an engine or a pool given no slice runs over."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    arr = np.empty((1, 1), dtype=object)
    arr[0, 0] = LogicalDevice(0, dev)
    return Mesh(arr, ("data", "model"))


def _make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
               devices=None) -> Mesh:
    devs = local_devices() if devices is None else list(devices)
    need = int(np.prod(shape))
    if need > len(devs):
        raise ValueError(f"a {shape} mesh needs {need} devices but only "
                         f"{len(devs)} are available")
    arr = np.empty(need, dtype=object)
    arr[:] = devs[:need]
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16) = 256 devices.
    Multi-pod:  (pod=2, data=16, model=16) = 512 devices; the pod axis is
    pure data parallelism (checkpoint / elastic ops work at pod
    granularity, training/ft.py)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes)


def make_host_mesh(n_devices: int | None = None, model: int = 1) -> Mesh:
    """Small mesh over the local devices (tests / examples).

    ``model`` must divide the device count: a (n // model, model) mesh over
    a non-divisible count would silently use only (n // model) * model
    devices and strand the rest — surfaced as an error instead."""
    n = n_devices or len(local_devices())
    if model <= 0 or n % model != 0:
        used = (n // model) * model if model > 0 else 0
        raise ValueError(
            f"model={model} does not divide n_devices={n}: a "
            f"({max(n // model, 0)}, {model}) mesh would use {used} "
            f"device(s) and strand {n - used}")
    return _make_mesh((n // model, model), ("data", "model"))


def mesh_slices(n_slices: int, devices_per_slice: int, *,
                devices=None) -> list[Mesh]:
    """Carve a device list into ``n_slices`` DISJOINT (data=1, model=d)
    meshes — one per serving replica, so each replica's params and KV pool
    collocate on its own slice (no two replicas share a logical device).

    ``devices`` defaults to ``local_devices()``; the allocation is a plain
    prefix split, so callers that manage a free pool (``ServeNode``) pass
    exactly the devices they own."""
    devs = local_devices() if devices is None else list(devices)
    if n_slices <= 0 or devices_per_slice <= 0:
        raise ValueError(f"need positive n_slices={n_slices} and "
                         f"devices_per_slice={devices_per_slice}")
    need = n_slices * devices_per_slice
    if need > len(devs):
        raise ValueError(
            f"{n_slices} slice(s) x {devices_per_slice} device(s) needs "
            f"{need} devices but only {len(devs)} are available")
    return [_make_mesh((1, devices_per_slice), ("data", "model"),
                       devs[s * devices_per_slice:(s + 1) * devices_per_slice])
            for s in range(n_slices)]
