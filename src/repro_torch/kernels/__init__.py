"""Hand-written Hopper kernels of the port and their plain versions."""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

_workspaces: dict[tuple[torch.device, torch.dtype], torch.Tensor] = {}
_holds: list[list[torch.Tensor]] = []
_work_sinks: list = []


def record_work(name: str, flops: int, nbytes: int) -> None:
    """A kernel's meta route reports the operations and bytes its kernel
    would do on the meta inputs (each wrapper's ``work`` count, the same
    function ``chip_smoke.py``'s bounds read) to every sink of
    ``work_sink``."""
    for sink in _work_sinks:
        sink(name, flops, nbytes)


@contextlib.contextmanager
def work_sink(fn) -> Iterator[None]:
    """Inside the block, ``fn(name, flops, nbytes)`` receives every meta
    route's ``record_work``."""
    _work_sinks.append(fn)
    try:
        yield
    finally:
        _work_sinks.remove(fn)


def workspace(device: torch.device, n: int,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A scratch buffer of at least ``n`` elements of ``dtype`` on
    ``device``, kept for later calls of every kernel wrapper (it only
    grows), so a steady-state call allocates nothing.  The kernels run in
    stream order, so the calls of one stream may share it.

    Growing drops the dict's reference to the old buffer.  A CUDA graph
    keeps raw pointers, so a capture runs inside ``holding()``, whose list
    keeps every buffer handed out meanwhile alive (and so out of the
    caching allocator's hands) for as long as the graph holds the list."""
    buf = _workspaces.get((device, dtype))
    if buf is None or buf.numel() < n:
        _workspaces.pop((device, dtype), None)
        buf = torch.empty(n, dtype=dtype, device=device)
        _workspaces[(device, dtype)] = buf
    for held in _holds:
        if not any(b is buf for b in held):
            held.append(buf)
    return buf


@contextlib.contextmanager
def holding() -> Iterator[list[torch.Tensor]]:
    """Collect every buffer ``workspace`` hands out inside the block into
    the yielded list: the owner of a captured graph keeps it as long as the
    graph lives."""
    held: list[torch.Tensor] = []
    _holds.append(held)
    try:
        yield held
    finally:
        _holds.remove(held)


def _counted() -> dict:
    """The kernel wrappers whose ``launches`` count kernel launches."""
    from .decode_attention import ops as da
    from .flash_attention import ops as fa
    from .ssd import ops as sd

    return {"ragged_paged_attention": da.ragged_paged_attention,
            "decode_attention": da.decode_attention,
            "flash_attention": fa.flash_attention, "ssd": sd.ssd}


def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's ``launches``, by name."""
    return {name: fn.launches for name, fn in _counted().items()}


def capture(graph: torch.cuda.CUDAGraph, stream: torch.cuda.Stream,
            step) -> tuple[list[torch.Tensor], dict[str, int]]:
    """Capture ``step()`` into ``graph`` on ``stream``.  Returns the
    workspaces the graph's kernels point into (the graph's owner keeps them
    as long as the graph) and the launches the capture counted, which are
    taken back here since nothing ran: each replay adds them again
    (``add_launches``).

    ``capture_begin`` / ``capture_end``, not ``torch.cuda.graph()``: that
    also empties the allocator's cache, which would send every later eager
    allocation back to cudaMalloc."""
    before = launch_counts()
    with holding() as held, torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            step()
        finally:
            graph.capture_end()
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    add_launches({k: -n for k, n in launches.items()})
    return held, launches


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (by wrapper name) to the wrappers' ``launches``: a
    replayed graph launches what its capture counted, while the wrappers'
    Python ran only at the capture."""
    for name, fn in _counted().items():
        fn.launches += counts.get(name, 0)
