"""Slices: how one process drives the shards of a tensor-parallel slice.

A slice (``TensorParallel``) is one row of a mesh's 'model' axis: one
local param tree (and local caches or pool) per shard.  The blocks of
``lm`` and ``mamba2`` run each half on every shard (``per_shard``, which
marks the shard whose work it is), then reduce the partials in shard order
(``combine``) or concatenate the pieces (``gather``), recording each
collective in the ledger (``core.sharded.record_collective``).  An
unsharded call is a slice of one shard, which reduces nothing.

The dry run (``launch.dryrun``) runs only a slice's first shard on meta,
standing for the others (``TensorParallel.group``); ``tiled`` repeats the
pieces that ran, and only for meta tensors.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.core.sharded import record_collective, shard_mark


@dataclass(frozen=True)
class TensorParallel:
    """How a step runs over a slice of shards (one row of a mesh's 'model'
    axis): one local param tree (and local caches or pool) per shard, all
    driven by this one process.  An unsharded call is a slice of one shard
    that splits nothing, so it reduces nothing and launches what one block
    body in a loop does.

    ``devices``: each shard's torch device, in mesh order (several shards
    may share one).  ``heads``: the q heads (``wq``, ``wo``) are split, so
    each shard's ``wo`` output is a partial sum; ``ffn``: the ffn columns
    are split, so is each ``w_down`` output; ``vocab``: each shard's (lo,
    hi) rows of the embedding table (and head), or None when the table is
    replicated.  ``kv_heads``: for each shard, the (k0, k1) kv heads of a
    replicated cache or pool its q heads read, or None (split like the q
    heads, or nothing split).  ``ssm``: Mamba-2 blocks split by SSM heads
    (their ``in_proj`` columns and conv channels in the shard-major layout
    of ``mamba2.shard_columns``); ``ssm_state``: the SSM decode state is
    split by heads too (else every shard holds all of it).  ``seq``: the
    decode caches are split over the sequence, (group size, its stride in
    mesh order); each shard's attention cache is then the list of the
    parts it reads.  ``group``: the slice's shard count when only its
    first shards run (the dry run runs one on meta, whose shapes are every
    shard's): collectives are recorded over the whole group, and a gather
    tiles the pieces that ran to the whole's shape.  ``experts``: the MoE
    layers' experts lie over the mesh's rows (``moe.RowExperts``, this
    row's view of them), or None.  ``gather``: the params lie over the
    mesh's rows too (over 'data'); ``gather(shard, path, subtree)`` is the
    subtree at ``path`` of a shard's local params with those leaves
    gathered whole, at each use (``launch.spmd.RowGather``), or None."""
    devices: tuple
    heads: bool = False
    ffn: bool = False
    vocab: tuple | None = None
    kv_heads: tuple = (None,)
    ssm: bool = False
    ssm_state: bool = False
    seq: tuple | None = None
    group: int | None = None
    experts: object = None
    gather: object = None

    @property
    def size(self) -> int:
        """The slice's shard count (collective group size)."""
        return self.group or len(self.devices)

    @functools.cached_property
    def first(self) -> dict:
        """Each distinct device → the first shard on it (mesh order)."""
        out: dict = {}
        for s, d in enumerate(self.devices):
            out.setdefault(d, s)
        return out


def on_devices(t, tp: TensorParallel) -> dict:
    """``t`` on every device of the slice (no copy where it lies)."""
    return {d: None if t is None else t.to(d, non_blocking=True)
            for d in tp.first}


def per_shard(tp: TensorParallel, fn) -> list:
    """``fn(s, d)`` for every shard, each marked as its shard's work (the
    mark set directly, with no call: this runs for every half of every
    layer, and an eager step is bound by the host)."""
    out = []
    prev = shard_mark.shard
    try:
        for s, d in enumerate(tp.devices):
            shard_mark.shard = s
            out.append(fn(s, d))
    finally:
        shard_mark.shard = prev
    return out


def sum_ordered(parts: list, d):
    """The parts summed in order on device ``d``."""
    total = parts[0].to(d, non_blocking=True)
    for t in parts[1:]:
        total = total + t.to(d, non_blocking=True)
    return total


def record(kind: str, t: torch.Tensor, group: int) -> None:
    """Report a collective of result ``t`` over ``group`` shards; under
    grad its backward (the all-reduce of the replicated input's grad)
    too."""
    nbytes = t.numel() * t.element_size()
    record_collective(kind, nbytes, group)
    if t.requires_grad:
        t.register_hook(lambda g: record_collective("all-reduce", nbytes,
                                                    group))


def combine(ys: list, tp: TensorParallel, split: bool, dtype) -> dict:
    """A half's output on every device.  Split: each shard's f32 parts
    (a tensor, or ``moe``'s list) summed in shard order on every device,
    rounded once to ``dtype``, the parts then added in order, so every
    copy of the residual stream holds the same bits (an all-reduce).  Not
    split: every shard holds the whole output already (summing would
    scale it)."""
    if not split:
        return {d: ys[s] for d, s in tp.first.items()}
    parts = [y if isinstance(y, list) else [y] for y in ys]
    out = {}
    for d in tp.first:
        y = None
        for j in range(len(parts[0])):
            total = sum_ordered([p[j] for p in parts], d).to(dtype)
            y = total if y is None else y + total
        out[d] = y
    for j in range(len(parts[0])):
        record("all-reduce", parts[0][j], tp.size)
    return out


def tiled(xs: list, group: int) -> list:
    """The pieces of every shard of a group of ``group``: those that ran,
    repeated over the group when only the first ran, which only the dry
    run does, on meta (every shard's piece has the first's shape)."""
    if len(xs) == group:
        return xs
    if any(x.device.type != "meta" for x in xs):
        raise ValueError(f"{len(xs)} of a group of {group} shards ran: only "
                         f"the dry run's meta tensors stand in for shards")
    return xs * (group // len(xs))


def gather(xs: list, tp: TensorParallel, dim: int) -> dict:
    """Each shard's piece concatenated along ``dim`` in shard order, on
    every device (an all-gather); one shard's piece is itself."""
    if tp.size == 1:
        return {d: xs[0].to(d, non_blocking=True) for d in tp.first}
    out = {d: torch.cat([x.to(d, non_blocking=True)
                         for x in tiled(xs, tp.size)], dim=dim)
           for d in tp.first}
    record("all-gather", next(iter(out.values())), tp.size)
    return out
