"""Counting a sharded program run on meta tensors (the dry run's counter).

``CostCounter`` is a ``TorchDispatchMode`` that records, for every aten op
the program runs:

- FLOPs, by ``torch.utils.flop_counter``'s registered formulas (matmuls,
  convolutions, attention; elementwise ops count none);
- bytes read and written, as the op's input and output sizes (view ops
  move nothing).  Eager ops do not fuse, so this is an upper bound on the
  bytes a fused program would move;
- the live bytes of every storage the program allocates, until it is
  freed (a weak reference on the storage), the largest of them
  (``largest``), and every storage an op reads (``read``: an argument no
  op reads is one XLA's compiled program drops);
- the shard that ran the op: the slice loop's mark (``core.sharded.
  on_shard``), else the shard of its inputs (an op whose inputs come from
  one shard is that shard's, as a backward op is its forward's); an op of
  no shard or of several runs on every device ("common").

The hand-written kernels' meta routes report their kernels' own counts
(``kernels.record_work``), attributed to the marked shard.  A device's
figure is the common share plus its shard's; the per-device figure is the
largest shard's.  Collectives are recorded by the program itself
(``core.sharded.record_collective``) into the ledger ``CostCounter``
opens.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import kernels
from repro_torch.core.sharded import collectives, current_shard

_COMMON = -1
_FREE = {torch.ops.aten.detach.default, torch.ops.aten.alias.default,
         torch.ops.aten.lift_fresh.default}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Use as a context manager around one run of a program on meta
    tensors; read ``per_device()`` after."""

    def __init__(self) -> None:
        super().__init__()
        self.flops: dict[int, float] = defaultdict(float)
        self.bytes: dict[int, float] = defaultdict(float)
        self.kernel_flops: dict[str, float] = defaultdict(float)
        self.ops = 0
        self._live: dict[int, int] = defaultdict(int)
        self._peak: dict[int, int] = defaultdict(int)
        self._owner: dict[int, tuple[int, int]] = {}
        self._marks = WeakIdKeyDictionary()
        self._refs: list = []
        self._total = 0
        self.total_peak = 0
        # (bytes, shape of the tensor that allocated it, shard)
        self.largest: tuple = (0, (), _COMMON)
        self.read: set[int] = set()
        self._ledger_cm = None
        self.ledger = None

    # ------------------------------------------------------------ context
    def __enter__(self):
        self._ledger_cm = collectives()
        self.ledger = self._ledger_cm.__enter__()
        self._sink_cm = kernels.work_sink(self._kernel_work)
        self._sink_cm.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._sink_cm.__exit__(*exc)
        self._ledger_cm.__exit__(*exc)
        return out

    def mark(self, tree, shard: int) -> None:
        """Attribute the tensors of ``tree`` (a shard's arguments) to
        ``shard``."""
        for t in _tensors(tree):
            self._marks[t] = shard

    # ------------------------------------------------------------ records
    def _shard_of(self, inputs: list[torch.Tensor]) -> int:
        s = current_shard()
        if s is not None:
            return s
        seen = {self._marks.get(t, _COMMON) for t in inputs}
        seen.discard(_COMMON)
        return seen.pop() if len(seen) == 1 else _COMMON

    def _kernel_work(self, name: str, flops: int, nbytes: int) -> None:
        s = current_shard()
        s = _COMMON if s is None else s
        self.flops[s] += flops
        self.bytes[s] += nbytes
        self.kernel_flops[name] += flops

    def _device_live(self, s: int) -> int:
        if s == _COMMON:
            shards = [v for k, v in self._live.items() if k != _COMMON]
            return self._live[_COMMON] + max(shards, default=0)
        return self._live[_COMMON] + self._live[s]

    def _alloc(self, t: torch.Tensor, s: int) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._owner:
            return
        n = st.nbytes()
        if n > self.largest[0]:
            self.largest = (n, tuple(t.shape), s)
        self._owner[key] = (s, n)
        self._live[s] += n
        self._total += n
        self.total_peak = max(self.total_peak, self._total)
        if s == _COMMON:
            for k in list(self._live):
                self._peak[k] = max(self._peak[k], self._device_live(k))
            self._peak[_COMMON] = max(self._peak[_COMMON],
                                      self._device_live(_COMMON))
        else:
            self._peak[s] = max(self._peak[s], self._device_live(s))
        self._refs.append(weakref.ref(st, lambda _, key=key: self._free(key)))

    def _free(self, key: int) -> None:
        s, n = self._owner.pop(key, (None, 0))
        if s is not None:
            self._live[s] -= n
            self._total -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        inputs = _tensors((args, kwargs))
        s = self._shard_of(inputs)
        outputs = _tensors(out)
        for t in outputs:
            self._marks[t] = s
        if func.is_view or func in _FREE:
            return out
        self.read.update(t.untyped_storage()._cdata for t in inputs)
        counter = flop_registry.get(func.overloadpacket)
        if counter is not None:
            self.flops[s] += counter(*args, **kwargs, out_val=out)
        if func.overloadpacket not in (torch.ops.aten.empty,
                                       torch.ops.aten.empty_strided,
                                       torch.ops.aten.empty_like):
            self.bytes[s] += sum(map(_nbytes, inputs)) + sum(
                map(_nbytes, outputs))
        in_storages = {t.untyped_storage()._cdata for t in inputs}
        for t in outputs:
            if t.untyped_storage()._cdata not in in_storages:
                self._alloc(t, s)
        return out

    # ------------------------------------------------------------- reads
    def per_device(self) -> dict:
        """The largest shard's figures, each with the common share:
        ``flops``, ``bytes_accessed``, ``peak_bytes`` (the most live bytes
        the program had allocated at once) and ``live_bytes`` (allocated by
        the program and still live: its outputs)."""
        shards = [k for k in set(self.flops) | set(self.bytes)
                  | set(self._peak) if k != _COMMON] or [_COMMON]

        def top(d):
            common = d.get(_COMMON, 0)
            return max(common + (d.get(k, 0) if k != _COMMON else 0)
                       for k in shards)

        return {"flops": top(self.flops), "bytes_accessed": top(self.bytes),
                "peak_bytes": max(self._peak.values(), default=0),
                "live_bytes": max(self._device_live(k) for k in shards),
                "shards": len([k for k in shards if k != _COMMON]) or 1,
                "ops": self.ops}

    def reads(self, t: torch.Tensor) -> bool:
        """Whether some op read ``t``'s storage."""
        return t.untyped_storage()._cdata in self.read

    def total_flops(self) -> float:
        """FLOPs of every shard and the common share counted once: the
        whole program's, for a slice whose common share is not replicated
        work."""
        return sum(self.flops.values())
