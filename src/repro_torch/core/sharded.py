"""Tensors placed over a mesh.

A ``Placement`` is (mesh, spec), the counterpart of a ``NamedSharding``: a
spec is a tuple with one entry per leading leaf dim, None (replicated), a
mesh axis name, or a tuple of names (``PartitionSpec``'s entries).
``place`` puts a tensor over a mesh as a ``ShardedTensor`` (the
counterpart of a sharded ``jax.Array``): one contiguous local tensor per
logical device, in mesh order, each on its device.  A mesh axis of size 1
splits nothing; a replicated dim puts the same bits on every shard.
Placements and gathers are device-to-device copies, never host pulls.

Format code only: the rules that choose a leaf's spec
(``launch.sharding``) read model configs; nothing here does.

The sharded programs' bookkeeping lives here too, so the models can report
without reading the launcher: ``on_shard`` marks which shard of a slice
the code in its block runs for (``launch.costs`` attributes operations by
it), and ``record_collective`` reports each reduction between shards, in
the reference dry run's five names and its ring model (``ring_bytes``), to
every ledger of ``collectives``.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from collections import Counter
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Iterator

import torch

from repro_torch.tree import tree_leaves, tree_map

if TYPE_CHECKING:
    from repro_torch.launch.mesh import Mesh


@dataclass(frozen=True)
class Placement:
    """A leaf's layout over ``mesh``: ``spec`` names, for each leading dim,
    the mesh axes it is split over (dims past the spec are replicated)."""
    mesh: Mesh
    spec: tuple

    def _dim_axes(self, dim: int) -> tuple[str, ...]:
        entry = self.spec[dim] if dim < len(self.spec) else None
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def parts(self, dim: int) -> int:
        """Into how many pieces dim ``dim`` is cut."""
        shape = self.mesh.shape
        n = 1
        for a in self._dim_axes(dim):
            n *= shape[a]
        return n

    def splits(self, ndim: int) -> bool:
        """True iff some dim is cut into more than one piece."""
        return any(self.parts(i) > 1 for i in range(ndim))

    def slices(self, shape: tuple[int, ...]) -> list[tuple[slice, ...]]:
        """The region of the global ``shape`` each logical device holds,
        in mesh order (row-major over the mesh axes)."""
        names, sizes = self.mesh.axis_names, self.mesh.devices.shape
        for dim, n in enumerate(shape):
            if n % self.parts(dim):
                raise ValueError(
                    f"dim {dim} of {tuple(shape)} ({n}) is not divisible by "
                    f"the {self.parts(dim)} pieces of spec {self.spec} over "
                    f"mesh {self.mesh.shape}")
        out = []
        for coord in itertools.product(*(range(s) for s in sizes)):
            at = dict(zip(names, coord))
            region = []
            for dim, n in enumerate(shape):
                piece = 0
                for a in self._dim_axes(dim):
                    piece = piece * self.mesh.shape[a] + at[a]
                size = n // self.parts(dim)
                region.append(slice(piece * size, (piece + 1) * size))
            out.append(tuple(region))
        return out

    def devices(self) -> list[torch.device]:
        return [ld.device for ld in self.mesh.devices.flat]


class ShardedTensor:
    """A tensor placed over a mesh: ``shards`` are contiguous local tensors,
    one per logical device in mesh order, each on that device's torch
    device.  The counterpart of a sharded ``jax.Array``."""

    def __init__(self, placement: Placement, shape: tuple[int, ...],
                 shards: list[torch.Tensor]) -> None:
        if len(shards) != placement.mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{placement.mesh.size} devices")
        self.placement = placement
        self.shape = tuple(shape)
        self.shards = shards

    @property
    def mesh(self) -> Mesh:
        return self.placement.mesh

    @property
    def spec(self) -> tuple:
        return self.placement.spec

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nbytes(self) -> int:
        """Bytes of every shard together (replicas counted each time)."""
        return sum(t.numel() * t.element_size() for t in self.shards)

    def gather(self, device) -> torch.Tensor:
        """The global tensor on ``device``, assembled from the shards
        (each region copied once, from the first shard that holds it)."""
        out = torch.empty(self.shape, dtype=self.dtype,
                          device=torch.device(device))
        done = set()
        for region, shard in zip(self.placement.slices(self.shape),
                                 self.shards):
            key = tuple((r.start, r.stop) for r in region)
            if key not in done:
                out[region].copy_(shard, non_blocking=True)
                done.add(key)
        return out


def place(tensor: torch.Tensor, mesh: Mesh, spec: tuple) -> ShardedTensor:
    """``tensor`` placed over ``mesh`` by ``spec``: each logical device gets
    its own contiguous copy of its region (replicas too), on its device —
    except on a one-device mesh, whose one shard is ``tensor`` itself when
    it already lies there, contiguous.  A meta tensor's shards are meta
    tensors of the regions' shapes (there is nothing to copy)."""
    pl = Placement(mesh, tuple(spec))
    if tensor.device.type == "meta":
        return ShardedTensor(pl, tuple(tensor.shape), [
            torch.empty(tuple(r.stop - r.start for r in region),
                        dtype=tensor.dtype, device="meta")
            for region in pl.slices(tuple(tensor.shape))])
    if (mesh.size == 1 and tensor.device == pl.devices()[0]
            and tensor.is_contiguous()):
        # a one-device slice holds the tensor itself, as the unsharded
        # engine does: nothing to split, nobody to share it with
        return ShardedTensor(pl, tuple(tensor.shape), [tensor])
    shards = []
    for region, dev in zip(pl.slices(tuple(tensor.shape)), pl.devices()):
        src = tensor[region]
        local = torch.empty(src.shape, dtype=src.dtype, device=dev)
        local.copy_(src, non_blocking=True)
        shards.append(local)
    return ShardedTensor(pl, tuple(tensor.shape), shards)


def full(placement: Placement, shape: tuple[int, ...], fill,
         dtype: torch.dtype) -> ShardedTensor:
    """A ShardedTensor of ``shape`` filled with ``fill``, each shard made
    directly on its device."""
    shards = []
    for region, dev in zip(placement.slices(tuple(shape)),
                           placement.devices()):
        local = tuple(r.stop - r.start for r in region)
        shards.append(torch.zeros(local, dtype=dtype, device=dev) if fill == 0
                      else torch.full(local, fill, dtype=dtype, device=dev))
    return ShardedTensor(placement, tuple(shape), shards)


def reshard(leaf, placement: Placement) -> ShardedTensor:
    """A tensor or ShardedTensor moved onto ``placement`` (gathered on its
    first shard's device, then placed)."""
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.gather(leaf.shards[0].device)
    return place(leaf, placement.mesh, placement.spec)


def local_tree(tree: Any, shard: int) -> Any:
    """Shard ``shard``'s local tensors of a tree of ShardedTensors."""
    return tree_map(lambda leaf: leaf.shards[shard], tree)


def place_tree(tree: Any, placements: Any) -> Any:
    """Every tensor of ``tree`` placed by the Placement at the same place
    in ``placements`` (a congruent tree, or one Placement for all)."""
    if isinstance(placements, Placement):
        return tree_map(lambda t: reshard(t, placements), tree)
    it = iter(tree_leaves(placements))
    return tree_map(lambda t: reshard(t, next(it)), tree)


# ====================================================== shard bookkeeping
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


class _ShardMark(threading.local):
    """This thread's shard mark: ``shard`` is the position in the slice of
    the shard whose work runs now, or None."""
    shard: int | None = None


shard_mark = _ShardMark()


def current_shard() -> int | None:
    """The shard ``on_shard`` (or ``models.slices.per_shard``) marks on
    this thread, or None."""
    return shard_mark.shard


@contextlib.contextmanager
def on_shard(shard: int) -> Iterator[None]:
    """Mark the block as shard ``shard``'s work (its position in the
    slice)."""
    prev, shard_mark.shard = shard_mark.shard, shard
    try:
        yield
    finally:
        shard_mark.shard = prev


def ring_bytes(kind: str, nbytes: int, group: int) -> int:
    """Bytes one device moves for a collective whose result is ``nbytes``
    over a group of ``group`` devices (the reference dry run's ring model):
    all-reduce 2·b·(g-1)/g, all-gather and all-to-all b·(g-1)/g,
    reduce-scatter b·(g-1), collective-permute b."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}")
    g = max(1, int(group))
    if kind == "all-reduce":
        return int(2 * nbytes * (g - 1) / g)
    if kind in ("all-gather", "all-to-all"):
        return int(nbytes * (g - 1) / g)
    if kind == "reduce-scatter":
        return int(nbytes * (g - 1))
    return int(nbytes)


class Ledger:
    """Per-device bytes moved by each kind of collective."""

    def __init__(self) -> None:
        self.bytes = {c: 0 for c in COLLECTIVES}
        # bytes by span: how many consecutive devices a group covers
        self.by_span: Counter = Counter()

    def record(self, kind: str, nbytes: int, group: int,
               stride: int = 1) -> None:
        if group <= 1:
            return
        moved = ring_bytes(kind, nbytes, group)
        self.bytes[kind] += moved
        self.by_span[group * stride] += moved


_ledgers: list[Ledger] = []


def record_collective(kind: str, nbytes: int, group: int,
                      stride: int = 1) -> None:
    """Report one collective (result ``nbytes``, ``group`` devices
    ``stride`` apart in mesh order) to every ledger of ``collectives``; a
    group of one moves nothing."""
    for ledger in _ledgers:
        ledger.record(kind, nbytes, group, stride)


@contextlib.contextmanager
def collectives() -> Iterator[Ledger]:
    """A ledger of the collectives recorded inside the block."""
    ledger = Ledger()
    _ledgers.append(ledger)
    try:
        yield ledger
    finally:
        _ledgers.remove(ledger)
