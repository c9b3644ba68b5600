"""Sharded dense programs over a (data, model) or (pod, data, model) mesh.

The counterpart of the reference's ``jax.jit`` with ``in_shardings`` over
the production mesh, for the dense entry points: ``Program`` places the
params, caches and batch by the logical-axis rules (``launch.sharding``)
and runs ``models.forward`` / ``prefill`` / ``decode_step`` row by row:
each row of the mesh (one group of 'model' shards, a ``TensorParallel``)
runs its local batch, and each shard its local heads, ffn columns, vocab
rows and SSM heads.  ``train_step`` adds the gradient reduction over the
rows and over the shards that replicate a leaf, in shard order, the
clipped global norm over every shard's leaves, and the optimizer's
lockstep update (``Optimizer.update_shards``).

Mamba-2 params and conv caches are placed in the shard-major layout of
``models.mamba2.shard_columns`` (so the rules' even split of the ``ffn``
dim is a split by SSM heads); ``gather_*`` undo it.

A decode step over caches split over the sequence (``long_500k``: batch 1,
``cache_seq`` over 'data') runs the rows in lockstep: one row's program,
each shard's attention over the parts of its cache that the rows hold,
merged by their log-sum-exps (``attention._seq_merge``).

A MoE config on a mesh of several rows (Stage 5: the rules put the experts
over 'data' wherever it divides ``n_experts``) runs the rows in token
order, each MoE layer of a row routing its own tokens in the batch's
groups, placing each entry after the entries the rows before gave its
expert (``moe.ExpertChain``'s carried counts), and sending each slice of
its dispatch buffer to the row that owns those experts and back
(``moe.RowExperts``); the aux loss is formed from every row's sums.  A
train step runs a reference microbatch's pieces forward first and then
one backward over its loss, and reduces an expert leaf's gradient over
the rows that hold the same slice only (autograd already brought every
row's part to its owner).

A prefill building such caches (Stage 4) runs each distinct batch row's
program once: at batch 1 the first row's, standing for every row (so the
dry run's per-device FLOPs of such a prefill are that row's, as they are
of any replicated batch).  Each row's shards build their caches over the
whole sequence; each device then keeps the parts of them that
``cache_placements`` give it (an all-to-all over the rows).

What the port does not yet run raises ``NotImplementedError`` naming its
stage (``coverage``): a decode step over a cache split over both the batch
and the sequence.
"""
from __future__ import annotations

import dataclasses
import re
from collections import Counter

import numpy as np
import torch

from repro_torch.core.sharded import (Placement, ShardedTensor, local_tree,
                                      place, record_collective)
from repro_torch.models import (cache_axes, decode_step, forward, layer_specs,
                                param_axes, prefill, stacked_leaves)
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba2 import shard_columns
from repro_torch.models.moe import ExpertChain, RowExperts
from repro_torch.tree import named_leaves, tree_leaves, tree_map

from .mesh import Mesh
from .sharding import (batch_shardings, leaf_spec, make_rules, map_axes,
                       opt_state_axes, tensor_parallel, tree_shardings)

_MAMBA_COLS = re.compile(r"mamba/(in_proj|conv_w|conv_b)(/|$)")
_CONV_CACHE = re.compile(r"^\d+/conv$")


def _axis_size(mesh: Mesh, target) -> int:
    if target is None:
        return 1
    n = 1
    for a in (target if isinstance(target, tuple) else (target,)):
        n *= mesh.shape.get(a, 1)
    return n


def coverage(cfg: ModelConfig, mesh: Mesh, rules: dict, *,
             kind: str) -> None:
    """Raise ``NotImplementedError`` naming the stage a sharded program of
    ``cfg`` over ``mesh`` needs and the port lacks; ``kind``: "train" /
    "score", "prefill" or "decode"."""
    attn = any(s.kind != "mamba" for s in layer_specs(cfg))
    if kind == "decode" and attn and rules["cache_seq"] is not None \
            and rules["cache_batch"] is not None:
        raise NotImplementedError(
            f"Stage 4 covers decode steps over a cache split over the "
            f"sequence or over the batch; one split over both (config "
            f"{cfg.name}, mesh {mesh.shape}) is not ported")
    for name, axes in named_leaves(param_axes(cfg),
                                   is_leaf=lambda x: isinstance(x, tuple)):
        for ax, entry in zip(axes, leaf_spec(axes, rules)):
            if entry not in (None, "model") and ax != "expert" and \
                    _axis_size(mesh, entry) > 1:
                raise NotImplementedError(
                    f"params split over {entry!r} (param {name}): the "
                    f"sharded steps split params over 'model' only, and "
                    f"experts over the rows")


class Program:
    """The sharded dense programs of ``cfg`` over ``mesh`` by ``rules``
    (default ``make_rules(cfg, mesh, batch=batch)``)."""

    def __init__(self, cfg: ModelConfig, mesh: Mesh, *,
                 rules: dict | None = None, batch: int | None = None,
                 represent: bool = False):
        self.cfg, self.mesh = cfg, mesh
        self.rules = make_rules(cfg, mesh, batch=batch) if rules is None \
            else rules
        self.m = mesh.shape.get("model", 1)
        self.n_rows = mesh.size // self.m
        self.tps = [tensor_parallel(cfg, mesh, rules=self.rules, row=r)
                    for r in range(self.n_rows)]
        # ``represent``: run each row's first shard only, standing for all
        # (on meta every shard has its shapes; the dry run's per-device
        # figures are one shard's); collectives keep the whole group
        self.m_run = 1 if represent else self.m
        if represent:
            self.tps = [dataclasses.replace(
                tp, devices=tp.devices[:1], kv_heads=tp.kv_heads[:1],
                vocab=tp.vocab[:1] if tp.vocab else None, group=self.m)
                for tp in self.tps]
        self.param_placements = tree_shardings(param_axes(cfg), mesh,
                                               self.rules)
        self.cols = (shard_columns(cfg, self.m) if self.tps[0].ssm
                     else None)
        self.represent = represent
        self.seq_rows = self._seq_rows()
        # a MoE config over several rows couples them (one batch's groups
        # and aux); ``owners[r]``: for each slice of the experts, the row
        # that holds it among row r's neighbours over the expert axes
        self.coupled = bool(cfg.n_experts) and self.n_rows > 1
        self.owners = self._owner_rows() if self.coupled else None

    def _owner_rows(self) -> list[list[int]]:
        """For each row, the rows holding each slice of the experts (in
        expert order) that differ from it only over the expert axes."""
        pl = Placement(self.mesh, leaf_spec(("expert", "embed", "ffn"),
                                            self.rules))
        shape = (self.cfg.n_experts, self.cfg.d_model, self.cfg.moe_d_ff)
        regions = pl.slices(shape)
        axes = set(pl._dim_axes(0))
        names = self.mesh.axis_names
        coords = list(np.ndindex(self.mesh.devices.shape))
        key = lambda r: tuple(c for a, c in zip(names, coords[r * self.m])
                              if a not in axes and a != "model")
        slot = {(key(r), regions[r * self.m][0].start): r
                for r in range(self.n_rows)}
        starts = sorted({reg[0].start for reg in regions})
        return [[slot[(key(r), st)] for st in starts]
                for r in range(self.n_rows)]

    def row_experts(self, r: int, trees, offset: int,
                    chain: ExpertChain) -> RowExperts:
        """Row r's view of the experts over the rows, its tokens starting
        at ``offset`` of the chain's batch; ``trees(i)``: device i's local
        param tree (the dry run's row stands in for every owner)."""
        owners = [[(self.tps[r if self.represent else o].devices[s],
                    trees((r if self.represent else o) * self.m + s))
                   for s in range(self.m_run)] for o in self.owners[r]]
        return RowExperts(chain, offset, owners, self.m)

    def _row_tps(self, rows, positions: ShardedTensor, trees) -> dict:
        """Each row's slice, with its view of the experts where the rows
        are coupled: the rows that hold the same part of the batch form a
        chain (one per replica of it), in token order."""
        if not self.coupled:
            return {r: self.tps[r] for r in rows}
        S = positions.shape[1]
        regions = positions.placement.slices(positions.shape)
        seen: Counter = Counter()
        chains: dict = {}
        out = {}
        for r in rows:
            reg = regions[r * self.m][0]
            q = seen[(reg.start, reg.stop)]
            seen[(reg.start, reg.stop)] += 1
            chain = chains.setdefault(q, ExpertChain(
                self.cfg, positions.shape[0] * S))
            out[r] = dataclasses.replace(self.tps[r], experts=self.row_experts(
                r, trees, reg.start * S, chain))
        return out

    def _seq_rows(self) -> list[int]:
        """The rows holding the parts of a decode cache split over the
        sequence, in part order (one per part; empty when not split)."""
        if _axis_size(self.mesh, self.rules["cache_seq"]) <= 1 or all(
                s.kind == "mamba" for s in layer_specs(self.cfg)):
            return []
        pl = Placement(self.mesh, leaf_spec(("cache_batch", "cache_seq"),
                                            self.rules))
        parts = _axis_size(self.mesh, self.rules["cache_seq"])
        first: dict = {}
        for i, region in enumerate(pl.slices((1, parts))):
            first.setdefault(region[1].start, i // self.m)
        return [first[k] for k in sorted(first)]

    # ---------------------------------------------------------- placement
    def _columns(self, name: str, t: torch.Tensor, *,
                 inverse: bool = False) -> torch.Tensor:
        """``t`` with its last dim in (or back from) the shard-major
        Mamba-2 layout, where ``name`` is such a leaf's."""
        if self.cols is None or t.dim() == 0:
            return t
        proj, conv = self.cols
        if _MAMBA_COLS.search(name) or _CONV_CACHE.search(name):
            idx = next((i for i in (proj, conv)
                        if t.shape[-1] == len(i)), None)
            if idx is not None:
                idx = torch.argsort(idx) if inverse else idx
                return t.index_select(-1, idx.to(t.device))
        return t

    def _place(self, tree, placements, permute: bool = True):
        names = [n for n, _ in named_leaves(tree)]
        pls = iter(tree_leaves(placements))
        it = iter([place(self._columns(n, t) if permute else t, self.mesh,
                         next(pls).spec)
                   for n, t in zip(names, tree_leaves(tree))])
        return tree_map(lambda _: next(it), tree)

    def _gather(self, tree, device):
        names = [n for n, _ in named_leaves(tree)]
        it = iter([self._columns(n, st.gather(device), inverse=True)
                   for n, st in zip(names, tree_leaves(tree))])
        return tree_map(lambda _: next(it), tree)

    def place_params(self, params):
        """The params as ShardedTensors by the rules."""
        return self._place(params, self.param_placements)

    def gather_params(self, placed, device="cpu"):
        return self._gather(placed, device)

    def cache_placements(self):
        return tree_shardings(cache_axes(self.cfg), self.mesh, self.rules)

    def place_caches(self, caches):
        coverage(self.cfg, self.mesh, self.rules, kind="decode")
        return self._place(caches, self.cache_placements())

    def gather_caches(self, placed, device="cpu"):
        return self._gather(placed, device)

    def place_batch(self, batch: dict) -> dict:
        """A batch's tensors placed with their leading dim over the rules'
        batch axes."""
        pls = batch_shardings(batch, self.mesh, self.rules)
        return {k: place(v, self.mesh, pls[k].spec) for k, v in
                batch.items()}

    def opt_placements(self, opt_name: str):
        return map_axes(lambda a: Placement(self.mesh,
                                            leaf_spec(a, self.rules)),
                        opt_state_axes(opt_name, param_axes(self.cfg),
                                       self.cfg))

    def place_state(self, state, opt_name: str):
        """A ``TrainState`` (params, OptState) placed by the rules."""
        from repro_torch.training.train import TrainState

        return TrainState(self.place_params(state.params),
                          self._place(state.opt_state,
                                      self.opt_placements(opt_name)))

    def gather_state(self, placed, device="cpu"):
        from repro_torch.training.train import TrainState

        return TrainState(self._gather(placed.params, device),
                          self._gather(placed.opt_state, device))

    def init_state(self, opt, params_placed):
        """The optimizer state of placed params, each shard's made from its
        own leaves (no copy of the whole state on any device)."""
        from repro_torch.training.train import TrainState

        locals_ = [opt.init(stacked_leaves(local_tree(params_placed, i),
                                           self.cfg))
                   for i in range(self.mesh.size)]
        pls = tree_leaves(self.opt_placements(opt.name))
        flat = [tree_leaves(st) for st in locals_]
        shape_of = lambda pl, t: tuple(
            n * pl.parts(i) for i, n in enumerate(t.shape))
        leaves = [ShardedTensor(pl, shape_of(pl, flat[0][j]),
                                [f[j] for f in flat])
                  for j, pl in enumerate(pls)]
        it = iter(leaves)
        return TrainState(params_placed, tree_map(lambda _: next(it),
                                                  locals_[0]))

    # ----------------------------------------------------------- programs
    def _rows(self, rows):
        return range(self.n_rows) if rows is None else rows

    def _local(self, tree, r: int) -> list:
        return [local_tree(tree, r * self.m + s) for s in range(self.m_run)]

    def _row_input(self, t: ShardedTensor, r: int) -> torch.Tensor:
        return t.shards[r * self.m]

    def _rows_out(self, outs: dict, like: ShardedTensor) -> ShardedTensor:
        """Each row's output (on its first shard's device) as a
        ShardedTensor split like ``like``'s leading dim."""
        shards = []
        for i, ld in enumerate(self.mesh.devices.flat):
            shards.append(outs[i // self.m].to(ld.device, non_blocking=True))
        shape = (like.shape[0],) + tuple(shards[0].shape[1:])
        return ShardedTensor(Placement(self.mesh, like.spec[:1]), shape,
                             shards)

    def forward(self, params, inputs, positions, *, mode="score", rows=None):
        """``models.forward`` over the mesh: (logits, aux) per row run
        (``rows`` None: all, as ShardedTensor logits)."""
        coverage(self.cfg, self.mesh, self.rules, kind="score")
        tps = self._row_tps(self._rows(rows), positions,
                            lambda i: local_tree(params, i))
        out = {r: forward(self._local(params, r),
                          self._row_input(inputs, r),
                          self._row_input(positions, r), self.cfg, mode=mode,
                          tp=tp)
               for r, tp in tps.items()}
        if rows is not None:
            if self.coupled:        # the batch's aux, from every row's sums
                out = {r: (o[0], tps[r].experts.chain.aux(o[0].device))
                       for r, o in out.items()}
            return out
        return self._rows_out({r: o[0] for r, o in out.items()}, inputs)

    def prefill(self, params, inputs, positions, *, max_len: int,
                rows=None):
        """``models.prefill`` over the mesh: (logits, caches), the caches
        placed by the rules (``rows`` given: each row's raw (logits, the
        shards' cache lists))."""
        coverage(self.cfg, self.mesh, self.rules, kind="prefill")
        if self.seq_rows:
            return self._seq_prefill(params, inputs, positions, max_len,
                                     rows)
        tps = self._row_tps(self._rows(rows), positions,
                            lambda i: local_tree(params, i))
        out = {r: prefill(self._local(params, r), self._row_input(inputs, r),
                          self._row_input(positions, r), self.cfg,
                          max_len=max_len, tp=tp)
               for r, tp in tps.items()}
        if rows is not None:
            return out
        pls = tree_leaves(self.cache_placements())
        per = [tree_leaves(out[i // self.m][1][i % self.m])
               for i in range(self.mesh.size)]
        shapes = [tuple(n * pl.parts(k) for k, n in enumerate(t.shape))
                  for pl, t in zip(pls, per[0])]
        leaves = iter([ShardedTensor(pl, shape, [p[j] for p in per])
                       for j, (pl, shape) in enumerate(zip(pls, shapes))])
        caches = tree_map(lambda _: next(leaves), out[0][1][0])
        return self._rows_out({r: o[0] for r, o in out.items()},
                              inputs), caches

    def _seq_prefill(self, params, inputs, positions, max_len: int, rows):
        """``prefill`` building caches split over the sequence: each
        distinct batch row's program runs once (``represent``: the first
        requested row's, standing for every row) and its shards build
        their caches over the whole sequence; each device then copies out
        of them the region ``cache_placements`` give it (a device whose
        batch spans rows assembles its part from each of them)."""
        want = list(self._rows(rows))
        regions = inputs.placement.slices(inputs.shape)
        batch = lambda r: (regions[r * self.m][0].start,
                           regions[r * self.m][0].stop)
        owner: dict = {}
        for r in range(self.n_rows):
            owner.setdefault(batch(r), r)
        sources = sorted(set(owner.values()))
        run = want[:1] if self.represent else sources
        tps = self._row_tps(run, positions, lambda i: local_tree(params, i))
        out = {r: prefill(self._local(params, r), self._row_input(inputs, r),
                          self._row_input(positions, r), self.cfg,
                          max_len=max_len, tp=tp)
               for r, tp in tps.items()}
        # the row that ran for row q (on meta, the one that ran stands in)
        ran = lambda q: q if q in out else run[0]
        whole = {**self.rules, "cache_seq": None}
        src_pls = tree_leaves(tree_shardings(cache_axes(self.cfg), self.mesh,
                                             whole))
        dst_pls = tree_leaves(self.cache_placements())
        src = {r: [tree_leaves(c) for c in o[1]] for r, o in out.items()}
        parts = _axis_size(self.mesh, self.rules["cache_seq"])
        devs = [r * self.m + s for r in (range(self.n_rows) if rows is None
                                         else want)
                for s in range(self.m_run)]
        leaves = []
        for j, (spl, dpl) in enumerate(zip(src_pls, dst_pls)):
            t0 = src[run[0]][0][j]
            shape = tuple(n * spl.parts(k) for k, n in enumerate(t0.shape))
            have, need = spl.slices(shape), dpl.slices(shape)
            if spl.spec != dpl.spec:
                record_collective("all-to-all", t0.numel() * t0.element_size(),
                                  parts, self.m)
            shards = {}
            for i in devs:
                s = i % self.m
                dev = self.mesh.devices.flat[i].device
                piece = torch.empty(tuple(d.stop - d.start for d in need[i]),
                                    dtype=t0.dtype, device=dev)
                for q in sources:
                    cut = [slice(max(a.start, b.start), min(a.stop, b.stop))
                           for a, b in zip(need[i], have[q * self.m + s])]
                    if any(c.start >= c.stop for c in cut):
                        continue
                    part = src[ran(q)][s][j][tuple(
                        slice(c.start - b.start, c.stop - b.start)
                        for c, b in zip(cut, have[q * self.m + s]))]
                    piece[tuple(slice(c.start - a.start, c.stop - a.start)
                                for c, a in zip(cut, need[i]))] = part.to(
                        dev, non_blocking=True)
                shards[i] = piece
            leaves.append((dpl, shape, shards))
        logits = {r: out[ran(owner[batch(r)])][0]
                  for r in range(self.n_rows)}
        like = out[run[0]][1][0]
        if rows is not None:
            return {r: (logits[r], [_rebuild(like, [
                sh[r * self.m + s] for _, _, sh in leaves])
                for s in range(self.m_run)]) for r in want}
        caches = _rebuild(like, [ShardedTensor(pl, shape, [
            sh[i] for i in range(self.mesh.size)])
            for pl, shape, sh in leaves])
        return self._rows_out(logits, inputs), caches

    def decode_step(self, params, caches, inputs, positions, *, rows=None):
        """``models.decode_step`` over the mesh; ``caches`` (placed) are
        updated in place.  Returns the logits (each row's, ``rows``
        given)."""
        coverage(self.cfg, self.mesh, self.rules, kind="decode")
        if self.seq_rows:
            logits = self._seq_decode(params, caches, inputs, positions)
            out = {r: logits for r in self._rows(rows)}
        else:
            tps = self._row_tps(self._rows(rows), positions,
                                lambda i: local_tree(params, i))
            out = {r: decode_step(
                self._local(params, r), self._local(caches, r),
                self._row_input(inputs, r), self._row_input(positions, r),
                self.cfg, tp=tp)[0] for r, tp in tps.items()}
        return out if rows is not None else self._rows_out(out, inputs)

    def _seq_decode(self, params, caches, inputs, positions):
        """One decode step over caches split over the sequence: the batch
        is the same on every row, so the first row's program runs, each
        shard's attention layers reading the parts of its cache that the
        ``seq_rows`` hold (only the first when ``represent``); the other
        layers' caches are the first row's."""
        rows = self.seq_rows[:1] if self.represent else self.seq_rows
        stride = (self.seq_rows[1] - self.seq_rows[0]) * self.m
        tp = dataclasses.replace(self.tps[self.seq_rows[0]],
                                 seq=(len(self.seq_rows), stride))
        specs = layer_specs(self.cfg)
        local = []
        for s in range(self.m_run):
            trees = [local_tree(caches, r * self.m + s) for r in rows]
            local.append([trees[0][li] if spec.kind == "mamba"
                          else [t[li] for t in trees]
                          for li, spec in enumerate(specs)])
        r0 = self.seq_rows[0]
        if self.coupled:
            tp = dataclasses.replace(tp, experts=self.row_experts(
                r0, lambda i: local_tree(params, i), 0,
                ExpertChain(self.cfg, positions.shape[0])))
        return decode_step(self._local(params, r0), local,
                           self._row_input(inputs, r0),
                           self._row_input(positions, r0), self.cfg,
                           tp=tp)[0]

    # --------------------------------------------------------- train step
    def splits(self) -> dict:
        """Each JAX leaf name → its split dim over 'model' in the stacked
        leaf (a per-layer tuple adds the leading repeat axis), or None."""
        pls = stacked_leaves(self.param_placements, self.cfg)
        out = {}
        for name, pl in pls.items():
            stacked = isinstance(pl, tuple)
            pl = pl[0] if stacked else pl
            dims = [i for i, e in enumerate(pl.spec) if e == "model"
                    and self.m > 1]
            out[name] = (dims[0] + int(stacked)) if dims else None
        return out

    def spread(self) -> set:
        """The JAX leaf names whose leaves are split over the rows too (the
        experts over 'data')."""
        pls = stacked_leaves(self.param_placements, self.cfg)
        return {name for name, pl in pls.items()
                if _row_split(pl[0] if isinstance(pl, tuple) else pl)}

    def _grad_parts(self, acc: dict, j: int, shards, rows: list) -> list:
        """The parts summed into leaf ``j``'s grad on ``shards``: each
        distinct batch row's (``rows``) grads of that leaf, shard-major."""
        return [acc[r * self.m + q][j] for q in shards for r in rows]

    def _pieces(self, batch: dict, run: list, grad_accum: int):
        """(the distinct batch rows' first rows, their count, each
        reference microbatch's pieces in token order): a piece is (row r,
        its chunk i of c batch rows, microbatch mb, the chunk's first batch
        row); rows that replicate an earlier row's batch add nothing."""
        first = batch["inputs"]
        regions = [first.placement.slices(first.shape)[r * self.m][0]
                   for r in range(self.n_rows)]
        owner: dict = {}
        for r, g in enumerate(regions):
            owner.setdefault((g.start, g.stop), r)
        distinct = [r for r in run
                    if owner[(regions[r].start, regions[r].stop)] == r]
        B = first.shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} not divisible by grad_accum "
                             f"{grad_accum}")
        bm = B // grad_accum
        pieces = []
        for r in distinct:
            lo, hi = regions[r].start, regions[r].stop
            c = (hi - lo) // grad_accum
            if (hi - lo) % grad_accum:
                raise ValueError(f"a row's {hi - lo} rows do not split "
                                 f"into {grad_accum} chunks")
            for i in range(grad_accum):
                start = lo + i * c
                mb = start // bm
                if (start + c - 1) // bm != mb:
                    raise ValueError("a chunk straddles two microbatches")
                pieces.append((r, i, c, mb, start))
        pieces.sort(key=lambda p: (p[3], p[4]))
        return distinct, len(owner), bm, pieces

    def _regions(self, params) -> list[list[tuple]]:
        """For each param leaf, each device's region of it (a hashable
        key), in mesh order."""
        if getattr(self, "_leaf_regions", None) is None:
            self._leaf_regions = [
                [tuple((r.start, r.stop) for r in reg)
                 for reg in st.placement.slices(st.shape)]
                for st in tree_leaves(params)]
        return self._leaf_regions

    def train_step(self, opt, *, grad_accum: int = 1,
                   max_grad_norm: float = 1.0):
        """``train_step(state, batch, rows=None) -> (state, metrics)`` over
        the mesh, ``state`` and ``batch`` placed (``place_state``,
        ``place_batch``).  The loss is the reference's: microbatch i is
        rows [i·B/a, (i+1)·B/a) of the global batch, its CE a masked mean
        over it, the loss the mean over microbatches.  Each row splits its
        local batch into ``grad_accum`` chunks, each inside one reference
        microbatch, so the per-microbatch denominators (an all-reduce) make
        every chunk's share exact.  A microbatch's pieces run in token
        order; each runs its own backward, unless the rows are coupled
        (MoE), where all of them run forward first and one backward takes
        the microbatch's loss, its aux formed from every piece's sums.
        ``rows``: run only these rows (the dry run's one batch shard); the
        reductions over the others are then recorded, not run."""
        from repro_torch.training.train import TrainState

        cfg, m, m_run = self.cfg, self.m, self.m_run
        splits, spread = self.splits(), self.spread()
        coverage(cfg, self.mesh, self.rules, kind="train")

        def step(state, batch, rows=None):
            params, opt_state = state
            run = list(self._rows(rows))
            distinct, n_keys, bm, pieces = self._pieces(batch, run,
                                                        grad_accum)
            S = batch["positions"].shape[1]
            dev0 = self.tps[run[0]].devices[0]
            den = torch.zeros(grad_accum, dtype=torch.float32, device=dev0)
            mask = batch.get("mask")
            for r, i, c, mb, _ in pieces:
                # a chunk's token count: no host round trip either way
                den[mb] += (torch.sum(self._row_input(mask, r)[
                    i * c:(i + 1) * c]).to(dev0) if mask is not None else
                    float(c * batch["targets"].shape[1]))
            record_collective("all-reduce", 4 * grad_accum, n_keys, m)
            den = torch.clamp(den, min=1.0)

            def backward(group):
                """The pieces of one microbatch forward, then one backward:
                (each device's grads, the CE share, the aux, the loss
                share)."""
                mb = group[0][3]
                views: dict = {}

                def view(i):
                    if i not in views:
                        views[i] = tree_map(
                            lambda t: t.detach().requires_grad_(),
                            local_tree(params, i))
                    return views[i]

                chain = ExpertChain(cfg, bm * S) if self.coupled else None
                parts = []
                with torch.enable_grad():
                    for r, i, c, _, start in group:
                        sl = slice(i * c, (i + 1) * c)
                        local = {k: self._row_input(v, r)[sl]
                                 for k, v in batch.items()}
                        tp = self.tps[r]
                        if chain is not None:
                            tp = dataclasses.replace(
                                tp, experts=self.row_experts(
                                    r, view, (start - mb * bm) * S, chain))
                        logits, aux = forward(
                            [view(r * m + s) for s in range(m_run)],
                            local["inputs"], local["positions"], cfg,
                            mode="train", tp=tp, split_vocab=True)
                        part = self._nll(logits, local["targets"],
                                         local.get("mask"), tp)
                        del logits      # the backward keeps none of them
                        parts.append(part / den[mb].to(part.device))
                    if chain is not None:
                        aux = chain.aux(dev0)
                    part = parts[0]
                    for t in parts[1:]:
                        part = part + t.to(part.device)
                    total = (part + cfg.router_aux_coef *
                             aux.to(part.device)) / grad_accum
                    keys = sorted(views)
                    flat = [t for k in keys for t in tree_leaves(views[k])]
                    grads = torch.autograd.grad(total, flat,
                                                materialize_grads=True)
                per = len(flat) // len(keys)
                return ({k: list(grads[n * per:(n + 1) * per])
                         for n, k in enumerate(keys)},
                        part.detach(), aux.detach(), total.detach())

            acc: dict[int, list] = {}
            ce = torch.zeros(grad_accum, dtype=torch.float32, device=dev0)
            aux_mb = torch.zeros(grad_accum, dtype=torch.float32,
                                 device=dev0)
            loss = torch.zeros((), dtype=torch.float32, device=dev0)
            for mb in range(grad_accum):
                mine = [p for p in pieces if p[3] == mb]
                # uncoupled, a microbatch of several pieces holds no MoE
                # layer (its aux is zero), and each piece runs alone
                for group in ([mine] if self.coupled else
                              [[p] for p in mine]):
                    grads, part, aux, total = backward(group)
                    for key, g in grads.items():
                        # one chunk keeps the grads' own dtype; chunks add
                        # in f32
                        acc[key] = g if key not in acc else [
                            a.float() + b.float()
                            for a, b in zip(acc[key], g)]
                    ce[mb] += part.to(dev0)
                    aux_mb[mb] = aux.to(dev0)
                    loss = loss + total.to(dev0)
            record_collective("all-reduce", 4, n_keys, m)

            # every leaf's grad on every running device: summed over the
            # distinct batch rows, then over the model shards that
            # replicate it, in shard order; an expert leaf's over the rows
            # holding the same slice only (its owners' grads hold every
            # row's part already)
            pls = tree_leaves(self.param_placements)
            regions = self._regions(params)
            ref = tree_leaves(local_tree(params, 0))
            devs = [r * m + s for r in run for s in range(m_run)]
            grads_d: dict[int, list] = {i: [] for i in devs}
            for j, pl in enumerate(pls):
                rowsplit = _row_split(pl)
                split = pl.splits(ref[j].dim()) and m > 1
                if rowsplit:
                    group = self._replicas(regions[j])
                    record_collective("all-reduce", ref[j].numel() * 4,
                                      max(1, n_keys // len(self.owners[0])),
                                      m * len(self.owners[0]))
                else:
                    record_collective("all-reduce", ref[j].numel() * 4,
                                      n_keys * (1 if split else m),
                                      m if split else 1)
                done: dict = {}
                for i in devs:
                    r, s = divmod(i, m)
                    if rowsplit:
                        reps = [q for q in group[r] if q * m + s in acc]
                        key = (regions[j][i], tuple(reps))
                        parts = lambda: self._grad_parts(acc, j, [s], reps)
                    else:
                        key = s if split else None
                        parts = lambda: self._grad_parts(
                            acc, j, [s] if split else range(m_run),
                            distinct)
                    if key not in done:
                        ps = parts()
                        total = ps[0]
                        if len(ps) > 1:
                            total = total.float()
                            for t in ps[1:]:
                                total = total + t.to(total.device).float()
                            if grad_accum == 1:
                                total = total.to(ref[j].dtype)
                        done[key] = total
                    dev = self.tps[r].devices[s]
                    grads_d[i].append(done[key].to(dev, non_blocking=True))
                for a in acc.values():          # each part, now summed
                    a[j] = None
            # global norm: each region once (its first device's)
            sums = []
            for j in range(len(pls)):
                seen, t = set(), None
                for i in devs:
                    if regions[j][i] in seen:
                        continue
                    seen.add(regions[j][i])
                    v = torch.sum(torch.square(grads_d[i][j].float()))
                    t = v if t is None else t + v.to(t.device)
                sums.append(t.to(dev0))
            record_collective("all-reduce", 4 * len(pls), m)
            gnorm = torch.sqrt(torch.sum(torch.stack(sums)))
            scale = torch.clamp(max_grad_norm / (gnorm + 1e-9), max=1.0)
            # each distinct grad scaled once (devices that share a torch
            # device share a replicated leaf's grad)
            scaled: dict = {}
            clip = lambda g: scaled.setdefault(id(g), (
                g.float() * scale.to(g.device)).to(g.dtype))
            grads_d = {i: [clip(g) for g in gl]
                       for i, gl in grads_d.items()}
            # the update: in lockstep over each row's shards, or, where a
            # leaf lies over the rows too (experts over 'data'), over each
            # block of rows holding one copy of it
            blocks: dict = {}
            for r in run:
                base = (self.owners[r][0] if spread and not self.represent
                        else r)
                blocks.setdefault(base, []).append(r)
            step_t = None
            for block in blocks.values():
                idx = [r * m + s for r in block for s in range(m_run)]
                local = [local_tree(params, i) for i in idx]
                leaves = [stacked_leaves(t, cfg) for t in local]
                states = [local_tree(opt_state, i) for i in idx]
                gl = [stacked_leaves(_rebuild(t, grads_d[i]), cfg)
                      for i, t in zip(idx, local)]
                new = opt.update_shards(
                    leaves, states, gl, splits, m, rows=len(block),
                    spread=spread, row_group=(len(self.owners[0])
                                              if spread and self.represent
                                              else None))
                for i, st in zip(idx, new):
                    opt_state.step.shards[i] = st.step
                step_t = new[0].step
            metrics = {"ce": ce[grad_accum - 1], "aux_loss":
                       aux_mb[grad_accum - 1], "loss": loss,
                       "grad_norm": gnorm, "step": step_t}
            return TrainState(params, opt_state), metrics

        return step

    def _nll(self, logits, targets, mask, tp) -> torch.Tensor:
        """A piece's masked NLL sum: over the vocabulary's shards where the
        row's table is split (``vocab_nll_sum``: the logits never
        gathered), else of the whole logits (``nll_sum``)."""
        from repro_torch.training.train import nll_sum, vocab_nll_sum

        if tp.vocab is None:
            return nll_sum(logits.float(), targets, mask)
        return vocab_nll_sum(logits, targets, mask, tp)

    def _replicas(self, regions: list) -> list[list[int]]:
        """For each row, the rows whose first device holds the same region
        of a leaf (in mesh order)."""
        by: dict = {}
        for r in range(self.n_rows):
            by.setdefault(regions[r * self.m], []).append(r)
        return [by[regions[r * self.m]] for r in range(self.n_rows)]


def _row_split(pl: Placement) -> bool:
    """Whether a leaf's placement splits it over a mesh axis other than
    'model' (an expert leaf over 'data')."""
    return any(a != "model" and pl.mesh.shape[a] > 1
               for i in range(len(pl.spec)) for a in pl._dim_axes(i))


def _rebuild(like, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)

