"""KV-cache managers for continuous batching: dense slots and paged blocks
(port of the JAX package's ``serving/kvcache.py``).

Dense manager (``CacheManager``): the engine owns one set of per-layer
caches with batch dimension n_slots (``models.init_decode_caches``).  Each
slot is leased to a live request; a (batched) prefill produces caches whose
row is copied into the slot in place, on the device (the JAX package splices
it with a jitted dynamic_update_slice).  Slot positions live on the host.
This is the path of the configs whose decode state cannot be paged (SSM /
conv state carries the whole history in O(1) per request).

Paged manager (``PagedCacheManager``): every layer holds (num_blocks,
block_size, K, D) K/V tensors on the device (``models.init_paged_pools``),
and a request's cache is a *block table* — the physical blocks that back its
logical positions [0, ctx).  The engine's step updates the pool in place.
The pool is also an object of a ``core.devstore.DeviceStore`` (``devstore``
/ ``kv_key``; by default a store of its own under ``/kv/pool``): ``publish``
installs the pool tensors themselves as the key's next version, never a
copy, after every tick and every adoption, as the reference does after
each donated dispatch.

The paged host-side accounting is the reference's, line for line: a
per-replica prefix trie over prompt token blocks (``core.trie.PathTrie``),
block-aligned sharing by refcount (copy-on-write never copies),
chunk-granularity trie commit for same-tick sharing, commit-time dedup, LRU
eviction of unreferenced cached blocks, and block 0 reserved as the null
block that masked lanes scribble on.

A replica holds its pool over its slice (``mesh``; a one-device slice on
``device`` when none is given), placed by
``launch.sharding.kv_pool_shardings``; ``shard_pools`` is each shard's
local tree, which the engine's tick writes.  Over several shards every
leaf of ``pools`` is a ``ShardedTensor`` (kv heads split over 'model' when
divisible, else one copy a shard) and the store key registers the
placement tree, so each publish is a donate hit; a one-device slice's
``pools`` is its one shard's tree.  A spill gathers the GLOBAL blocks
(over kv heads) and an adoption scatters them into whatever slice this
replica holds.

Spill and restore (``spill_device`` / ``adopt``, with ``SpilledKV``) move a
live session's blocks off the device and back.  The gather and the scatter
are plain indexing on the block axis, as in the JAX package, over a bit
view of each leaf (so every pool dtype, fp8 included, moves bit for bit).
The scatter writes the existing pool tensors in place: a captured engine
tick keeps their pointers, so a pool leaf is never rebound.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.devstore import DeviceStore
from repro_torch.core.pools import PoolSpec
from repro_torch.core.trie import PathTrie
from repro_torch.core.sharded import ShardedTensor, full, local_tree
from repro_torch.launch.mesh import device_mesh
from repro_torch.launch.sharding import kv_pool_shardings
from repro_torch.models import init_decode_caches, init_paged_pools
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as the integer dtype of its element size: index ops
    exist for every integer dtype (not for fp8) and copy bits exactly."""
    return t.view(_BITS[t.element_size()])


def _gather_blocks(pools: list[dict], idx: torch.Tensor) -> list[dict]:
    """The blocks ``idx`` (table order) of every pool leaf, on the device:
    leaves (n, bs, K, D) / (n, bs, K), block axis 0."""
    return [{k: _bits(leaf).index_select(0, idx).view(leaf.dtype)
             for k, leaf in pool.items()} for pool in pools]


def _scatter_blocks(pools: list[dict], blocks: list[dict],
                    idx: torch.Tensor) -> None:
    """Write migrated ``blocks`` into the pool blocks ``idx``, IN PLACE
    (the JAX package returns a new donated pool instead)."""
    for pool, src in zip(pools, blocks):
        for k, leaf in pool.items():
            _bits(leaf).index_copy_(0, idx, _bits(src[k].to(leaf.dtype)))


def pack(tree: list[dict], *, pin: bool = False
         ) -> tuple[torch.Tensor, list[list[tuple]]]:
    """Every leaf's bytes in ONE flat uint8 tensor on the leaves' device
    (each leaf padded to 16 bytes, so every unpacked view is aligned), and
    the layout ``unpack`` reads; ``pin`` puts a host result in pinned
    memory, ready for a non-blocking upload."""
    parts, layout, off = [], [], 0
    for layer in tree:
        entry = []
        for k, t in layer.items():
            b = t.contiguous().reshape(-1).view(torch.uint8)
            pad = -b.numel() % 16
            parts.append(b)
            if pad:
                parts.append(b.new_zeros(pad))
            entry.append((k, t.dtype, tuple(t.shape), off, b.numel()))
            off += b.numel() + pad
        layout.append(entry)
    out = torch.empty(off, dtype=torch.uint8, device=parts[0].device,
                      pin_memory=pin)
    return torch.cat(parts, out=out), layout


def unpack(flat: torch.Tensor, layout: list[list[tuple]]) -> list[dict]:
    """The inverse of ``pack``: views into ``flat``, one dict per layer."""
    return [{k: flat[o:o + n].view(dt).view(shape)
             for k, dt, shape, o, n in entry} for entry in layout]


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``: through pinned memory and a
    non-blocking copy on the card (no host sync)."""
    if device.type != "cuda":
        return t.to(device)
    return (t if t.is_pinned() else t.pin_memory()).to(device,
                                                       non_blocking=True)


def upload(tree: list[dict], device: torch.device) -> list[dict]:
    """Host leaves on ``device`` in one packed copy (``to_device``)."""
    flat, layout = pack(tree, pin=device.type == "cuda")
    return unpack(to_device(flat, device), layout)


@dataclass
class SpilledKV:
    """A live session's committed KV, spilled off a replica: its table's
    blocks in TABLE ORDER on the host (one dict per layer of CPU tensors,
    leaves (n_blocks, bs, K, D) / (n_blocks, bs, K)), plus the position it
    resumes at.  Restoring allocates the same COUNT of fresh blocks and
    scatters these in, so the session decodes on at ``pos`` as if it had
    never moved (its KV is valid over [0, pos)).

    Failover spills a dead replica's live slots (``engine.evacuate``, then
    ``adopt`` on a sibling); preemption spills a victim into the host-side
    ``core.store.SpillPool``, where it parks until the request re-issues.
    ``adopt`` is the one restore site either way, with prompt replay
    (``Request.fold_for_replay``) as the fallback.
    ``models.spilled_to_numpy`` / ``spilled_from_numpy`` carry ``blocks``
    to and from the JAX package's tree."""
    request_id: str
    pos: int                      # next position to write on resume
    n_blocks: int
    block_size: int
    blocks: list                  # one dict of CPU tensors per layer

    @property
    def nbytes(self) -> int:
        """Host bytes this entry holds while parked (a property, so the
        store's ``CascadeObject.nbytes()`` sizes a parked entry)."""
        return sum(t.numel() * t.element_size()
                   for layer in self.blocks for t in layer.values())


@dataclass
class SlotState:
    request_id: str | None = None
    pos: int = 0            # next absolute position to decode
    active: bool = False


class CacheManager:
    """Dense per-slot caches: slot leases and host-side positions."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int, *,
                 device) -> None:
        self.cfg, self.n_slots, self.max_len = cfg, n_slots, max_len
        self.caches = init_decode_caches(cfg, n_slots, max_len, device=device)
        self.slots = [SlotState() for _ in range(n_slots)]

    def acquire(self, request_id: str) -> int | None:
        for i, s in enumerate(self.slots):
            if not s.active:
                self.slots[i] = SlotState(request_id=request_id, active=True)
                return i
        return None

    def release(self, slot: int) -> None:
        self.slots[slot] = SlotState()

    def insert_prefill(self, slot: int, src_caches: list[dict],
                       prompt_len: int, row: int = 0) -> None:
        """Copy row ``row`` of a (possibly batched) prefill's caches into
        ``slot``, in place; batched admission copies one row per admitted
        request.  A source leaf smaller than the slot's (a conv window of a
        prompt shorter than it) fills the leading corner, as the JAX
        package's dynamic_update_slice does."""
        for dst, src in zip(self.caches, src_caches):
            for k, leaf in dst.items():
                one = src[k][row]
                leaf[slot][tuple(slice(0, n) for n in one.shape)].copy_(one)
        self.slots[slot].pos = prompt_len

    def active_mask(self) -> np.ndarray:
        return np.asarray([s.active for s in self.slots], dtype=bool)

    def positions(self) -> np.ndarray:
        return np.asarray([s.pos for s in self.slots], dtype=np.int32)

    def advance(self) -> None:
        for s in self.slots:
            if s.active:
                s.pos += 1

    @property
    def n_active(self) -> int:
        return sum(s.active for s in self.slots)


@dataclass
class _CachedBlock:
    """Trie residency record for one full token block."""
    block: int
    key: str                 # trie path ("/<blk0>/<blk1>/.../<blki>")
    parent: str | None
    children: int = 0        # cached child blocks (pin: can't evict parents)
    last_used: int = 0       # allocator clock at last touch (LRU)


class PrefixBlockAllocator:
    """Host-side block accounting: free list, refcounts, and the token-block
    prefix trie.  Touches no device memory — it only hands out block ids.

    A prompt's i-th full block is the trie path component
    ``"-".join(tokens[i*bs:(i+1)*bs])``, so ``PathTrie.match`` over the
    whole prompt path returns exactly the chain of consecutive cached
    blocks."""

    def __init__(self, num_blocks: int, block_size: int, *,
                 enable_cache: bool = True) -> None:
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_cache = enable_cache
        # block 0 reserved: the null block masked lanes are clamped onto
        self.free: list[int] = list(range(num_blocks - 1, 0, -1))
        self.refcount = [0] * num_blocks
        self.trie: PathTrie[_CachedBlock] = PathTrie()
        self._cached: dict[str, _CachedBlock] = {}
        self._by_block: dict[int, _CachedBlock] = {}
        self._clock = 0
        self.evictions = 0
        self.dedup_blocks = 0    # duplicate blocks swapped for incumbents

    # ------------------------------------------------------------- helpers
    def _block_key(self, tokens: Sequence[int], i: int) -> str:
        """THE trie key encoding of one full token block (path component)."""
        bs = self.block_size
        return "-".join(str(int(t)) for t in tokens[i * bs:(i + 1) * bs])

    def _components(self, tokens: Sequence[int], n_blocks: int) -> list[str]:
        return [self._block_key(tokens, i) for i in range(n_blocks)]

    def _touch(self, meta: _CachedBlock) -> None:
        self._clock += 1
        meta.last_used = self._clock

    # --------------------------------------------------------------- match
    def match(self, tokens: Sequence[int], max_blocks: int) -> list[int]:
        """Longest chain of cached blocks covering a prefix of ``tokens``
        (capped at ``max_blocks``); matched blocks are ref'd and LRU-touched.
        """
        if not self.enable_cache:
            return []
        n_full = min(len(tokens) // self.block_size, max_blocks)
        if n_full <= 0:
            return []
        key = "/" + "/".join(self._components(tokens, n_full))
        chain = self.trie.match(key)          # shallow → deep, consecutive
        out = []
        for meta in chain:
            self.refcount[meta.block] += 1
            self._touch(meta)
            out.append(meta.block)
        return out

    # ------------------------------------------------------------ allocate
    def allocate(self, n: int) -> list[int] | None:
        """Pop ``n`` fresh blocks, evicting LRU unreferenced cached blocks
        as needed.  Returns None (allocating nothing) if that's impossible."""
        if n <= 0:
            return []
        while len(self.free) < n:
            if not self._evict_one():
                return None
        out = [self.free.pop() for _ in range(n)]
        for b in out:
            self.refcount[b] += 1
        return out

    def _evict_one(self) -> bool:
        best: _CachedBlock | None = None
        for meta in self._cached.values():
            if self.refcount[meta.block] == 0 and meta.children == 0:
                if best is None or meta.last_used < best.last_used:
                    best = meta
        if best is None:
            return False
        self.trie.remove(best.key, best)
        del self._cached[best.key]
        del self._by_block[best.block]
        if best.parent is not None:
            self._cached[best.parent].children -= 1
        self.free.append(best.block)
        self.evictions += 1
        return True

    def available(self) -> int:
        """Blocks obtainable right now: free + evictable (cached, unref'd).
        References land only on trie-incumbent blocks, so an unreferenced
        cached block heads an unreferenced subtree, which leaf-first
        iterated eviction can always reclaim."""
        evictable = sum(1 for m in self._cached.values()
                        if self.refcount[m.block] == 0)
        return len(self.free) + evictable

    @property
    def blocks_in_use(self) -> int:
        """Non-null blocks currently held (leased to requests or cached)."""
        return self.num_blocks - 1 - len(self.free)

    # --------------------------------------------------------------- cache
    def path_key(self, tokens: Sequence[int], n_blocks: int) -> str:
        """Trie path of the first ``n_blocks`` full blocks of ``tokens``
        ("" for zero blocks) — the resume point for ``cache_blocks_range``.
        """
        if n_blocks <= 0:
            return ""
        return "/" + "/".join(self._components(tokens, n_blocks))

    def cache_blocks(self, tokens: Sequence[int], table: list[int]) -> int:
        """Donate the full blocks of ``tokens`` (backed by ``table``) to the
        trie, walking from the root.  Returns how many were newly cached."""
        n_full = min(len(tokens) // self.block_size, len(table))
        added, _ = self.cache_blocks_range(tokens, table, 0, n_full, "")
        return added

    def cache_blocks_range(self, tokens: Sequence[int], table: list[int],
                           start: int, stop: int, prefix_key: str
                           ) -> tuple[int, str]:
        """Donate blocks [start, stop) of ``tokens`` to the trie, resuming
        under the already-committed path ``prefix_key``.  Chains strictly:
        block i is cached only under an existing (or just-created) parent.

        Commit-time dedup: when a path is already cached under a DIFFERENT
        physical block, ``table`` is rewritten in place to the cached
        incumbent and the duplicate block is released (same tokens, same
        positions, same K/V).  Returns (newly cached count, extended key)."""
        if not self.enable_cache:
            return 0, prefix_key
        added = 0
        key = prefix_key
        for i in range(start, stop):
            parent = key or None
            key += "/" + self._block_key(tokens, i)
            meta = self._cached.get(key)
            if meta is not None:
                self._touch(meta)
                blk = int(table[i])
                if blk != meta.block:
                    self.refcount[meta.block] += 1
                    self.refcount[blk] -= 1
                    assert self.refcount[blk] >= 0, \
                        f"refcount underflow on {blk}"
                    if self.refcount[blk] == 0 and blk not in self._by_block:
                        self.free.append(blk)
                    table[i] = meta.block
                    self.dedup_blocks += 1
                continue
            blk = int(table[i])
            if blk in self._by_block:
                continue
            meta = _CachedBlock(block=blk, key=key, parent=parent)
            self.trie.insert(key, meta)
            self._cached[key] = meta
            self._by_block[blk] = meta
            if parent is not None:
                self._cached[parent].children += 1
            self._touch(meta)
            added += 1
        return added, key

    # --------------------------------------------------------------- unref
    def unref(self, table: Sequence[int]) -> None:
        """Drop one reference per block; uncached blocks return to the free
        list at zero, cached blocks stay resident (evictable)."""
        for blk in table:
            blk = int(blk)
            self.refcount[blk] -= 1
            assert self.refcount[blk] >= 0, f"refcount underflow on {blk}"
            if self.refcount[blk] == 0 and blk not in self._by_block:
                self.free.append(blk)

    @property
    def n_cached(self) -> int:
        return len(self._cached)


@dataclass
class PagedSeq:
    """Per-slot request state: block table + positions + prompt tokens."""
    request_id: str | None = None
    prompt: np.ndarray | None = None   # host prompt tokens (trie keys)
    table: list[int] = field(default_factory=list)
    reused: int = 0                    # reused prefix length, tokens
    reserve: int = 0                   # worst-case total blocks this request
    prefill_pos: int = 0               # next prompt position to prefill
    committed: int = 0                 # full blocks already in the trie
    trie_key: str = ""                 # path of those blocks (resume point)
    pos: int = 0                       # next absolute position to decode
    active: bool = False


class PagedCacheManager:
    """Slots, block tables and the device pool of one engine replica."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int, *,
                 block_size: int = 16, num_blocks: int | None = None,
                 prefix_cache: bool = True, kv_dtype: str | None = None,
                 devstore: DeviceStore | None = None,
                 kv_key: str | None = None, device="cuda",
                 mesh=None) -> None:
        self.cfg, self.n_slots, self.max_len = cfg, n_slots, max_len
        self.block_size = block_size
        self.max_blocks = max(1, math.ceil(max_len / block_size))
        if num_blocks is None:
            # every slot can grow to max_len, plus null block, plus slack so
            # the prefix cache can retain blocks past their request
            num_blocks = 1 + (n_slots + 2) * self.max_blocks
        self.num_blocks = num_blocks
        self.kv_dtype = cfg.kv_dtype if kv_dtype is None else kv_dtype
        self.mesh = mesh if mesh is not None else device_mesh(device)
        self.device = self.mesh.devices.flat[0].device
        self.alloc = PrefixBlockAllocator(num_blocks, block_size,
                                          enable_cache=prefix_cache)
        # each shard's local leaves made on its own device; the scales
        # start at 1, as init_paged_pool's do.  A one-device slice holds
        # its one shard's tensors, as ``place`` gives them
        self.pool_shardings = kv_pool_shardings(cfg, self.mesh,
                                                kv_dtype=self.kv_dtype)
        shapes = init_paged_pools(cfg, num_blocks, block_size,
                                  kv_dtype=self.kv_dtype, device="meta")
        placed = [{k: full(pl[k], tuple(t.shape), int(k.endswith("_scale")),
                           t.dtype) for k, t in layer.items()}
                  for layer, pl in zip(shapes, self.pool_shardings)]
        self._leaf_shapes = [{k: tuple(t.shape) for k, t in layer.items()}
                             for layer in shapes]
        self.shard_pools = [local_tree(placed, i)
                            for i in range(self.mesh.size)]
        self.pools = placed if self.mesh.size > 1 else self.shard_pools[0]
        self.slots = [PagedSeq() for _ in range(n_slots)]
        if devstore is None:
            devstore = DeviceStore(self.device, keep_versions=1)
            devstore.create_pool(PoolSpec(path="/kv"))
        self.devstore = devstore
        self.kv_key = kv_key or "/kv/pool"
        self.devstore.register_sharding(
            self.kv_key, self.pool_shardings if self.mesh.size > 1
            else self.device)
        self.publish()

    # ----------------------------------------------------- devstore bridge
    def publish(self) -> None:
        """Install the pool on the device store as the key's next version:
        the pool tensors themselves (a donate hit), which the tick and
        ``adopt`` update in place, so the stored version is the live pool."""
        self.devstore.put(self.kv_key, self.pools, donate=True)

    def pool_bytes(self) -> int:
        """Device bytes of the whole pool (every layer, every leaf, every
        shard)."""
        return sum(t.nbytes if isinstance(t, ShardedTensor)
                   else t.numel() * t.element_size()
                   for t in tree_leaves(self.pools))

    def kv_bytes_per_token(self) -> float:
        """Device bytes the pool stores per token slot, summed over every
        layer's K/V (and, when quantized, scale) leaves."""
        return self.pool_bytes() / (self.num_blocks * self.block_size)

    # ------------------------------------------------------ slot interface
    def acquire(self, request_id: str) -> int | None:
        for i, s in enumerate(self.slots):
            if not s.active:
                self.slots[i] = PagedSeq(request_id=request_id, active=True)
                return i
        return None

    def release(self, slot: int) -> None:
        """Release without caching (error paths); ``finish`` is the normal
        completion route."""
        seq = self.slots[slot]
        if seq.table:
            self.alloc.unref(seq.table)
        self.slots[slot] = PagedSeq()

    @staticmethod
    def written_max(prompt_len: int, max_new_tokens: int) -> int:
        """Number of positions whose K/V gets written: the prompt plus
        max_new-1 fed-back tokens (the final sample is never written)."""
        return prompt_len + max(0, max_new_tokens - 1)

    def block_cost(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case block footprint of a request; ``begin`` reserves
        exactly this."""
        return min(self.max_blocks,
                   math.ceil(self.written_max(prompt_len, max_new_tokens)
                             / self.block_size))

    def begin(self, slot: int, prompt_tokens: np.ndarray,
              max_new_tokens: int) -> PagedSeq | None:
        """Build the request's block table: reuse every cached block of a
        block-aligned prompt prefix, allocate fresh blocks for the rest.
        At least one prompt token is always left to prefill, so a
        fully-cached prompt reuses one block less than it matched.  Returns
        None if blocks are exhausted."""
        seq = self.slots[slot]
        S = len(prompt_tokens)
        if S > self.max_len:
            self.release(slot)
            raise ValueError(f"prompt of {S} tokens exceeds max_len="
                             f"{self.max_len}")
        n_prompt_blocks = math.ceil(S / self.block_size)
        reuse_cap = (S - 1) // self.block_size
        matched = self.alloc.match(prompt_tokens, reuse_cap)
        fresh = self.alloc.allocate(n_prompt_blocks - len(matched))
        if fresh is None:
            self.alloc.unref(matched)
            self.release(slot)
            return None
        seq.prompt = np.asarray(prompt_tokens)
        seq.table = matched + fresh
        seq.reused = len(matched) * self.block_size
        seq.prefill_pos = seq.reused
        seq.committed = len(matched)
        seq.trie_key = self.alloc.path_key(seq.prompt, len(matched))
        seq.reserve = self.block_cost(S, max_new_tokens)
        return seq

    def commit_prefill_progress(self, slot: int, new_pos: int) -> bool:
        """Chunk-granularity trie commit: prompt positions [prefill_pos,
        new_pos) of this slot were just PACKED into the current tick; every
        full block now covered is donated to the trie at once (sound because
        the packed step writes all K/V before any token reads).  Returns
        True when the prompt is complete (the slot decodes at pos = S)."""
        seq = self.slots[slot]
        seq.prefill_pos = new_pos
        n_full = min(new_pos // self.block_size, len(seq.table))
        if n_full > seq.committed:
            _, seq.trie_key = self.alloc.cache_blocks_range(
                seq.prompt, seq.table, seq.committed, n_full, seq.trie_key)
            seq.committed = n_full
        if new_pos >= len(seq.prompt):
            seq.pos = len(seq.prompt)
            return True
        return False

    def finish(self, slot: int, generated: Sequence[int]) -> None:
        """Normal completion: cache the full blocks of everything whose K/V
        was written — prompt plus generated[:-1] — then drop the request's
        references."""
        seq = self.slots[slot]
        written = np.concatenate([
            seq.prompt, np.asarray(list(generated[:-1]), dtype=np.int64)
        ]) if len(generated) > 1 else seq.prompt
        n_full = min(len(written) // self.block_size, len(seq.table))
        if n_full > seq.committed:
            self.alloc.cache_blocks_range(written, seq.table, seq.committed,
                                          n_full, seq.trie_key)
        self.alloc.unref(seq.table)
        self.slots[slot] = PagedSeq()

    # ---------------------------------------------------------- decode I/O
    def ensure_decode_blocks(self, extra: dict[int, int] | None = None, *,
                             only: set[int] | None = None) -> None:
        """Grow each active slot's table to cover the position it is about to
        write, plus ``extra[slot]`` further positions for draft tokens
        verified in the same step.  ``only`` restricts growth to those slots
        (the mid-tick draft ensure must not grow a slot whose prompt just
        completed: its admission budget reserved no decode block yet)."""
        for i, seq in enumerate(self.slots):
            if not seq.active or (only is not None and i not in only):
                continue
            last = seq.pos + (extra.get(i, 0) if extra else 0)
            blk_idx = last // self.block_size
            if blk_idx >= self.max_blocks:
                raise RuntimeError(
                    f"request {seq.request_id} overran max_len={self.max_len}")
            while blk_idx >= len(seq.table):
                got = self.alloc.allocate(1)
                if got is None:
                    raise RuntimeError("KV block pool exhausted mid-decode "
                                       "(admission budget violated)")
                seq.table.extend(got)

    def rollback_writes(self, slot: int, valid_len: int) -> int:
        """Speculative-decode rollback: truncate the table to the blocks
        covering positions [0, valid_len) and free the (private) tail
        blocks.  Stale K/V inside the kept last block is hidden by the
        causal mask and rewritten before any token can attend to it.
        Returns the number of blocks freed."""
        seq = self.slots[slot]
        keep = max(math.ceil(valid_len / self.block_size), seq.committed)
        if keep >= len(seq.table):
            return 0
        tail = seq.table[keep:]
        del seq.table[keep:]
        self.alloc.unref(tail)
        return len(tail)

    # -------------------------------------------------- spill / restore
    def spill_device(self, slot: int) -> list[dict]:
        """Device-side gather of this slot's blocks, in table order, on the
        current stream (after the last tick's writes).  No host transfer
        happens here: the engine pulls the result through its one sync
        site, ``_to_host``."""
        idx = to_device(torch.tensor(self.slots[slot].table,
                                     dtype=torch.int64), self.device)
        # each shard's local blocks, assembled into the global blocks on
        # the first shard's device (device-to-device copies)
        local = [_gather_blocks(pools, idx.to(pools[0]["k"].device,
                                              non_blocking=True))
                 for pools in self.shard_pools]
        n = len(self.slots[slot].table)
        return [{k: ShardedTensor(pl, (n,) + self._leaf_shapes[li][k][1:],
                                  [shard[li][k] for shard in local]
                                  ).gather(self.device)
                 for k, pl in layer.items()}
                for li, layer in enumerate(self.pool_shardings)]

    def adopt(self, slot: int, prompt: np.ndarray, spilled: SpilledKV,
              max_new_tokens: int) -> PagedSeq | None:
        """Install a spilled session into ``slot``: allocate the same count
        of fresh blocks, scatter the migrated KV in (in place, one upload),
        and resume at ``spilled.pos``.  Accounting is the reference's: the
        fresh blocks are refcount-1 private (the source's trie residency did
        not travel), ``reserve`` is the request's worst-case footprint, and
        ``finish`` later donates prompt + generated blocks to this replica's
        trie.  Returns None (slot released, nothing allocated) when the
        block geometry differs or the pool cannot cover the worst case."""
        seq = self.slots[slot]
        S = len(prompt)
        reserve = self.block_cost(S, max_new_tokens)
        if (spilled.block_size != self.block_size
                or spilled.n_blocks > self.max_blocks
                or reserve > self.available_for_admission()):
            self.release(slot)
            return None
        fresh = self.alloc.allocate(spilled.n_blocks)
        if fresh is None:
            self.release(slot)
            return None
        seq.prompt = np.asarray(prompt)
        seq.table = list(fresh)
        seq.reused = 0
        seq.reserve = max(reserve, spilled.n_blocks)
        seq.prefill_pos = S            # prompt fully in KV already
        seq.committed = 0              # nothing trie-resident here yet
        seq.trie_key = ""
        seq.pos = spilled.pos
        *blocks, idx = upload(
            spilled.blocks + [{"idx": torch.tensor(fresh, dtype=torch.int64)}],
            self.device)
        self._scatter_sharded(blocks, idx["idx"])
        self.publish()
        return seq

    def _scatter_sharded(self, blocks: list[dict], idx: torch.Tensor) -> None:
        """Each shard's region of the global ``blocks`` (its kv heads, or
        all of them where the pool is replicated) scattered into its local
        pool, on its device."""
        for i, pools in enumerate(self.shard_pools):
            dev = pools[0]["k"].device
            local = []
            for layer, shapes, src in zip(self.pool_shardings,
                                          self._leaf_shapes, blocks):
                region = {k: pl.slices((len(idx),) + shapes[k][1:])[i]
                          for k, pl in layer.items()}
                local.append({k: src[k][region[k]].to(dev, non_blocking=True)
                              for k in layer})
            _scatter_blocks(pools, local, idx.to(dev, non_blocking=True))

    def block_tables(self, out: np.ndarray | None = None) -> np.ndarray:
        """(n_slots, max_blocks) int32 table, -1 = unused (inactive rows
        are all -1), written into ``out`` when given (the engine's staging
        buffer, so the device operand is never rebound)."""
        if out is None:
            bt = np.full((self.n_slots, self.max_blocks), -1, np.int32)
        else:
            bt = out
            bt.fill(-1)
        for r, seq in enumerate(self.slots):
            bt[r, :len(seq.table)] = seq.table
        return bt

    def available_for_admission(self) -> int:
        """Free+evictable blocks minus what active requests may still claim
        for decode growth — the budget the scheduler admits against."""
        outstanding = sum(max(0, s.reserve - len(s.table))
                          for s in self.slots if s.active)
        return self.alloc.available() - outstanding

    @property
    def n_active(self) -> int:
        return sum(s.active for s in self.slots)

    @property
    def blocks_in_use(self) -> int:
        return self.alloc.blocks_in_use
