"""Sharded dense programs over a (data, model) or (pod, data, model) mesh.

The counterpart of the reference's ``jax.jit`` with ``in_shardings`` over
the production mesh, for the dense entry points: ``Program`` places the
params, caches and batch by the logical-axis rules (``launch.sharding``)
and runs ``models.forward`` / ``prefill`` / ``decode_step`` over the rows
in lockstep, layer by layer (``models.forward_rows`` / ``prefill_rows``
/ ``decode_rows``): each row of the mesh (one group of 'model' shards, a
``TensorParallel``) runs its local batch, and each shard its local
heads, ffn columns, vocab rows and SSM heads.  ``train_step`` adds the gradient reduction over the
rows and over the shards that replicate a leaf, in shard order, the
clipped global norm over every shard's leaves, and the optimizer's
lockstep update (``Optimizer.update_shards``).

Mamba-2 params and conv caches are placed in the shard-major layout of
``models.mamba2.shard_columns`` (so the rules' even split of the ``ffn``
dim is a split by SSM heads); ``gather_*`` undo it.

Params split over the rows too (the reference's ``fsdp=True`` rules put
``embed`` over 'data') are gathered whole just before each use, inside
the layer loop (``TensorParallel.gather``, an all-gather; remat's
recompute gathers again); a train step hands each row's whole gradient of
such a leaf to the program, which sums the rows' gradients in shard order
and keeps each device's slice (a reduce-scatter).

A decode step over caches split over the sequence (``long_500k``: batch
1, ``cache_seq`` over 'data'; or a larger batch whose caches the rules
split over both: the batch over 'pod', or not at all) runs, for each
batch region of the caches, the rows holding its parts in lockstep: one
program over that region's batch, each shard's attention over the parts
of its cache that the rows hold, merged by their log-sum-exps
(``attention._seq_merge``); the regions run in turn.

A MoE config on a mesh of several rows (Stage 5: the rules put the experts
over 'data' wherever it divides ``n_experts``) couples the rows: each MoE
layer of a row routing
its own tokens in the batch's groups and placing each entry after the
entries the rows before gave its expert (``moe.ExpertChain``'s carried
counts); each owner of a slice of the experts runs the slots every row
sends it once, over the union of their groups, and sends each row its
outputs back (``moe.moe_rows``); the aux loss is formed from every row's
sums.  A train step runs a reference microbatch's pieces forward together
and then one backward over its loss, and reduces an expert leaf's
gradient over the rows that hold the same slice only (autograd already
brought every row's part to its owner).

A prefill building caches split over the sequence (Stage 4) runs each
distinct batch row's program once: at batch 1 the first row's, standing
for every row (so the dry run's per-device FLOPs of such a prefill are
that row's, as they are of any replicated batch).  Each row's shards build
their caches over the whole sequence; each device then keeps the parts of
them that ``cache_placements`` give it (an all-to-all over the rows).
"""
from __future__ import annotations

import dataclasses
import re
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.sharded import (Placement, ShardedTensor, local_tree,
                                      place, record_collective)
from repro_torch.models import (cache_axes, decode_rows, forward_rows,
                                layer_specs, param_axes, prefill_rows,
                                stacked_leaves)
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba2 import shard_columns
from repro_torch.models.moe import ExpertChain, Owner, RowExperts, group_span
from repro_torch.tree import named_leaves, tree_leaves, tree_map

from .mesh import Mesh
from .sharding import (batch_shardings, is_axes_leaf, leaf_spec, make_rules,
                       map_axes, opt_state_axes, tensor_parallel,
                       tree_shardings)

_MAMBA_COLS = re.compile(r"mamba/(in_proj|conv_w|conv_b)(/|$)")
_CONV_CACHE = re.compile(r"^\d+/conv$")


def _axis_size(mesh: Mesh, target) -> int:
    if target is None:
        return 1
    n = 1
    for a in (target if isinstance(target, tuple) else (target,)):
        n *= mesh.shape.get(a, 1)
    return n


class Gathered(NamedTuple):
    """A param leaf split over the rows on a dim that is not the experts'
    (params over 'data'): that dim, and for each device (mesh order) the
    position of its piece and the devices holding every piece, in piece
    order."""
    dim: int
    peers: list


class _Gather(torch.autograd.Function):
    """A leaf's pieces concatenated along ``dim``, ``own`` at ``at`` (an
    all-gather).  The backward hands the whole gradient of this use to
    ``sink`` and returns none to the piece: the program sums every row's
    gradient itself, in shard order, and keeps each slice (a
    reduce-scatter), so no sum is left to autograd's order."""

    @staticmethod
    def forward(ctx, own, pieces, at, dim, sink):
        ctx.sink = sink
        parts = list(pieces)
        parts[at] = own
        return torch.cat([t.to(own.device, non_blocking=True)
                          for t in parts], dim=dim)

    @staticmethod
    def backward(ctx, grad):
        ctx.sink(grad)
        return None, None, None, None, None


class RowGather:
    """``TensorParallel.gather`` of row ``r``: in a shard's subtree, each
    leaf that ``Program.gathered`` names is concatenated from the pieces of
    its peers (``params``' shards; the row's own piece as given, a view the
    train step differentiates).  ``sink(device, name, grad)``: under grad,
    where each use's whole gradient goes (``_Gather``)."""

    def __init__(self, prog: "Program", params, r: int, sink=None):
        self.prog, self.r, self.sink = prog, r, sink
        self.leaves = dict(named_leaves(params))

    def __call__(self, s: int, path: tuple, node):
        i = self.r * self.prog.m + s
        prefix = "/".join(map(str, path))
        out = []
        for sub, t in named_leaves(node):
            name = f"{prefix}/{sub}" if sub else prefix
            g = self.prog.gathered.get(name)
            out.append(t if g is None else self._whole(name, g, i, t))
        it = iter(out)
        return tree_map(lambda _: next(it), node)

    def _whole(self, name: str, g: Gathered, i: int, own: torch.Tensor):
        at, peers = g.peers[i]
        pieces = [self.leaves[name].shards[p] for p in peers]
        record_collective("all-gather", own.numel() * own.element_size()
                          * len(peers), len(peers), peers[1] - peers[0])
        if self.sink is not None and own.requires_grad:
            return _Gather.apply(own, pieces, at, g.dim,
                                 lambda grad: self.sink(i, name, grad))
        pieces[at] = own
        return torch.cat([t.to(own.device, non_blocking=True)
                          for t in pieces], dim=g.dim)


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
        self.gathered = self._gathered()
        self.blocks, self.row_group = self._blocks()
        self.seq_groups = self._seq_groups()
        # the rows holding the parts of the first batch region's caches
        self.seq_rows = self.seq_groups[0][2] if self.seq_groups else []
        # a MoE config over several rows couples them (one batch's groups
        # and aux, each MoE layer's expert slots); ``owners[r]``: for each slice of the experts, the row
        # that holds it among row r's neighbours over the expert axes
        self.coupled = bool(cfg.n_experts) and self.n_rows > 1
        self.owners = self._owner_rows() if self.coupled else None

    def _row_coords(self, r: int) -> dict:
        coords = list(np.ndindex(self.mesh.devices.shape))[r * self.m]
        return dict(zip(self.mesh.axis_names, coords))

    def _gathered(self) -> dict:
        """Each param leaf that the rules split over the rows on a dim that
        is not the experts' (params over 'data', the reference's fsdp
        rules): its name → ``Gathered``."""
        out = {}
        names = self.mesh.axis_names
        coords = list(np.ndindex(self.mesh.devices.shape))
        axes = named_leaves(param_axes(self.cfg), is_leaf=is_axes_leaf)
        for (name, ax), pl in zip(axes, tree_leaves(self.param_placements)):
            dims = [k for k, a in enumerate(ax) if a != "expert" and any(
                x != "model" and self.mesh.shape[x] > 1
                for x in pl._dim_axes(k))]
            if not dims:
                continue
            (dim,) = dims
            split = pl._dim_axes(dim)
            groups: dict = {}
            for i, c in enumerate(coords):
                at = dict(zip(names, c))
                piece = 0
                for x in split:
                    piece = piece * self.mesh.shape[x] + at[x]
                key = tuple(v for a, v in at.items() if a not in split)
                groups.setdefault(key, {})[piece] = i
            peers = []
            for i, c in enumerate(coords):
                at = dict(zip(names, c))
                group = groups[tuple(v for a, v in at.items()
                                     if a not in split)]
                order = [group[k] for k in sorted(group)]
                peers.append((order.index(i), order))
            out[name] = Gathered(dim, peers)
        return out

    def _blocks(self) -> tuple[list[list[int]], int]:
        """(the rows holding one copy of the params together: rows that
        differ only over the mesh axes that split some param leaf over the
        rows ('data': the experts, params under fsdp), in mesh order; how
        many rows a block holds)."""
        axes = {x for pl in tree_leaves(self.param_placements)
                for k in range(len(pl.spec)) for x in pl._dim_axes(k)
                if x != "model" and self.mesh.shape[x] > 1}
        by: dict = {}
        for r in range(self.n_rows):
            key = tuple(v for a, v in self._row_coords(r).items()
                        if a not in axes)
            by.setdefault(key, []).append(r)
        return (list(by.values()),
                int(np.prod([self.mesh.shape[x] for x in axes])))

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

    def row_experts(self, r: int, trees, offset: int, chain: ExpertChain,
                    members=()) -> RowExperts:
        """Row r's view of the experts over the rows, its tokens starting
        at ``offset`` of the chain's batch; ``trees(i)``: device i's local
        param tree (the dry run's row stands in for every owner).
        ``members``: (row, first token, tokens) of every row of the chain,
        for the dry run: its own slice's owner runs the groups that the
        rows sending to it touch."""
        owners = [[Owner(o * self.m + s,
                         self.tps[r if self.represent else o].devices[s],
                         trees((r if self.represent else o) * self.m + s))
                   for s in range(self.m_run)] for o in self.owners[r]]
        stand_in = None
        if self.represent:
            spans = [group_span(at, n, chain.total, self.cfg)
                     for q, at, n in members if r in self.owners[q]]
            spans = spans or [group_span(offset, 0, chain.total, self.cfg)]
            stand_in = (r * self.m, (min(a for a, _ in spans),
                                     max(b for _, b in spans)))
        return RowExperts(chain, offset, owners, self.m, stand_in)

    def _row_tps(self, rows, positions: ShardedTensor, params, trees=None,
                 sink=None) -> dict:
        """Each row's slice: its gathers where params lie over the rows
        (``RowGather`` of ``params``, ``trees(i)`` device i's tree, the
        local params by default), and its view of the experts where the
        rows are coupled: the rows that hold the same part of the batch
        form a chain (one per replica of it), in token order."""
        trees = trees or (lambda i: local_tree(params, i))
        gather = (lambda r: RowGather(self, params, r, sink)) \
            if self.gathered else (lambda r: None)
        if not self.coupled:
            return {r: dataclasses.replace(self.tps[r], gather=gather(r))
                    for r in rows}
        S = positions.shape[1]
        regions = positions.placement.slices(positions.shape)
        seen: Counter = Counter()
        chain_of, members = {}, {}
        for r in range(self.n_rows):
            reg = regions[r * self.m][0]
            chain_of[r] = seen[(reg.start, reg.stop)]
            seen[(reg.start, reg.stop)] += 1
            members.setdefault(chain_of[r], []).append(
                (r, reg.start * S, (reg.stop - reg.start) * S))
        chains: dict = {}
        out = {}
        for r in rows:
            q = chain_of[r]
            chain = chains.setdefault(q, ExpertChain(
                self.cfg, positions.shape[0] * S))
            out[r] = dataclasses.replace(
                self.tps[r], gather=gather(r), experts=self.row_experts(
                    r, trees, regions[r * self.m][0].start * S, chain,
                    members[q]))
        return out

    def _seq_groups(self) -> list[tuple[int, int, list[int]]]:
        """The batch regions of decode caches split over the sequence, as
        ``cache_placements`` place them (an attention layer's ``pos``
        leaf: its batch split over 'pod', or not at all, its sequence over
        'data'): for each, (region b, of n, the rows holding its parts in
        part order); empty when the caches are not split over the
        sequence."""
        specs = layer_specs(self.cfg)
        li = next((i for i, s in enumerate(specs) if s.kind != "mamba"),
                  None)
        if li is None:
            return []
        pl = self.cache_placements()[li]["pos"]
        nb, ns = pl.parts(0), pl.parts(1)
        if ns <= 1:
            return []
        regions = pl.slices((nb, ns))
        parts: dict = {}
        for r in range(self.n_rows):
            b, q = regions[r * self.m][0].start, regions[r * self.m][1].start
            parts.setdefault(b, {}).setdefault(q, r)
        return [(b, nb, [parts[b][q] for q in sorted(parts[b])])
                for b in sorted(parts)]

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
        tps = self._row_tps(self._rows(rows), positions, params)
        res = forward_rows([
            (self._local(params, r), self._row_input(inputs, r),
             self._row_input(positions, r), tp) for r, tp in tps.items()],
            self.cfg, mode=mode)
        out = dict(zip(tps, res))
        if rows is not None:
            if self.coupled:        # the batch's aux, from every row's sums
                out = {r: (o[0], tps[r].experts.chain.aux(o[0].device))
                       for r, o in out.items()}
            return out
        return self._rows_out({r: o[0] for r, o in out.items()}, inputs)

    def _prefill_rows(self, params, inputs, positions, max_len: int,
                      rows) -> dict:
        tps = self._row_tps(rows, positions, params)
        return dict(zip(tps, prefill_rows([
            (self._local(params, r), self._row_input(inputs, r),
             self._row_input(positions, r), tp) for r, tp in tps.items()],
            self.cfg, max_len=max_len)))

    def prefill(self, params, inputs, positions, *, max_len: int,
                rows=None):
        """``models.prefill`` over the mesh: (logits, caches), the caches
        placed by the rules (``rows`` given: each row's raw (logits, the
        shards' cache lists))."""
        if self.seq_groups:
            return self._seq_prefill(params, inputs, positions, max_len,
                                     rows)
        out = self._prefill_rows(params, inputs, positions, max_len,
                                 self._rows(rows))
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
        out = self._prefill_rows(params, inputs, positions, max_len, run)
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
        if self.seq_groups:
            out = self._seq_decode(params, caches, inputs, positions)
            out = {r: out[r] for r in self._rows(rows)}
        else:
            tps = self._row_tps(self._rows(rows), positions, params)
            out = dict(zip(tps, decode_rows([
                (self._local(params, r), self._local(caches, r),
                 self._row_input(inputs, r), self._row_input(positions, r),
                 tp) for r, tp in tps.items()], self.cfg)))
        return out if rows is not None else self._rows_out(out, inputs)

    def _batch_range(self, t: ShardedTensor, lo: int, hi: int, s: int,
                     device) -> tuple[torch.Tensor, list]:
        """Rows [lo, hi) of ``t``'s leading dim for shard s, on ``device``,
        from the rows whose shard s holds them (an all-gather where they
        are several), and (each holder's tensor, its rows, the rows of the
        result) to write an update back."""
        regions = t.placement.slices(t.shape)
        pieces, back, at = [], [], lo
        while at < hi:
            i = next(r * self.m + s for r in range(self.n_rows)
                     if regions[r * self.m + s][0].start <= at
                     < regions[r * self.m + s][0].stop)
            reg = regions[i][0]
            stop = min(reg.stop, hi)
            part = slice(at - reg.start, stop - reg.start)
            pieces.append(t.shards[i][part].to(device, non_blocking=True))
            back.append((t.shards[i], part, slice(at - lo, stop - lo)))
            at = stop
        if len(pieces) == 1:
            return pieces[0], back
        whole = torch.cat(pieces)
        record_collective("all-gather", whole.numel() * whole.element_size(),
                          len(pieces), self.m)
        return whole, back

    def _seq_decode(self, params, caches, inputs, positions) -> dict:
        """One decode step over caches split over the sequence: for each
        batch region of the caches (``seq_groups``; the first only when
        ``represent``), one program over that region's batch (its inputs
        gathered from the rows that hold them), each shard's attention
        layers reading the parts of its cache that the group's rows hold
        (only the first when ``represent``); a Mamba-2 layer's cache is
        the region's, assembled from the rows holding it and written back
        after.  The regions run in turn, one chain of the batch's MoE
        groups through them.  Returns each row's logits."""
        B = inputs.shape[0]
        specs = layer_specs(self.cfg)
        groups = self.seq_groups[:1] if self.represent else self.seq_groups
        chain = ExpertChain(self.cfg, B) if self.coupled else None
        regions = inputs.placement.slices(inputs.shape)
        members = [(group[0], b * B // nb, B // nb)
                   for b, nb, group in self.seq_groups]
        out: dict = {}
        for b, nb, group in groups:
            lo, hi = b * B // nb, (b + 1) * B // nb
            rows = group[:1] if self.represent else group
            r0 = group[0]
            stride = (group[1] - group[0]) * self.m
            tp = dataclasses.replace(self.tps[r0], seq=(len(group), stride))
            if self.gathered:
                tp = dataclasses.replace(tp, gather=RowGather(self, params,
                                                              r0))
            if chain is not None:
                tp = dataclasses.replace(tp, experts=self.row_experts(
                    r0, lambda i: local_tree(params, i), lo, chain, members))
            dev = tp.devices[0]
            local, writes = [], []
            for s in range(self.m_run):
                trees = [local_tree(caches, r * self.m + s) for r in rows]
                mine = []
                for li, spec in enumerate(specs):
                    if spec.kind != "mamba":
                        mine.append([t[li] for t in trees])
                        continue
                    layer = {}
                    for k, leaf in caches[li].items():
                        layer[k], back = self._batch_range(
                            leaf, lo, hi, s, tp.devices[s])
                        if len(back) > 1 or not _same(layer[k],
                                                      back[0][0]):
                            writes.append((layer[k], back))
                    mine.append(layer)
                local.append(mine)
            x, _ = self._batch_range(inputs, lo, hi, 0, dev)
            p, _ = self._batch_range(positions, lo, hi, 0, dev)
            logits = decode_rows([(self._local(params, r0), local, x, p,
                                   tp)], self.cfg)[0]
            for whole, back in writes:
                for holder, part, mine in back:
                    holder[part].copy_(whole[mine], non_blocking=True)
            for r in range(self.n_rows):
                reg = regions[r * self.m][0]
                if lo <= reg.start and reg.stop <= hi:
                    out[r] = logits[reg.start - lo:reg.stop - lo]
        return out

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

    def spread(self) -> dict:
        """Each JAX leaf name whose leaves are split over the rows too (the
        experts over 'data', params under fsdp) → its stacked leaf's dim
        split over the rows."""
        out = {}
        for name, pl in stacked_leaves(self.param_placements,
                                       self.cfg).items():
            stacked = isinstance(pl, tuple)
            pl = pl[0] if stacked else pl
            dims = [k for k in range(len(pl.spec)) if any(
                a != "model" and self.mesh.shape[a] > 1
                for a in pl._dim_axes(k))]
            if dims:
                out[name] = dims[0] + int(stacked)
        return out

    def _grad_parts(self, acc: dict, j: int, shards, rows: list) -> list:
        """The parts summed into leaf ``j``'s grad on ``shards``: each
        distinct batch row's (``rows``) grads of that leaf, shard-major."""
        return [acc[r * self.m + q][j] for q in shards for r in rows]

    def _scatter_parts(self, acc: dict, j: int, shards, rows: list,
                       cut: tuple) -> list:
        """The parts summed into a gathered leaf ``j``'s slice ``cut`` (a
        reduce-scatter): each part (``_grad_parts``: every running row's
        whole gradient of its uses) cut to the slice, summed in the same
        order as a replicated leaf's, so the slice is the same bits."""
        return [p[cut] for p in self._grad_parts(acc, j, shards, rows)]

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
        (MoE), where all of them run forward in lockstep and one backward
        takes the microbatch's loss, its aux formed from every piece's
        sums.  A leaf gathered from the rows (fsdp) gives each device the
        whole gradient of its uses; the program sums them as a replicated
        leaf's and keeps each device's slice.  ``rows``: run only these
        rows (the dry run's one batch shard); the reductions over the
        others are then recorded, not run."""
        from repro_torch.training.train import TrainState

        cfg, m, m_run = self.cfg, self.m, self.m_run
        splits, spread = self.splits(), self.spread()
        names = [n for n, _ in named_leaves(self.param_placements)]
        gathered = [(j, n) for j, n in enumerate(names) if n in self.gathered]

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
            # every row's pieces, for the dry run's stand-in owners
            every = (self._pieces(batch, list(range(self.n_rows)),
                                  grad_accum)[3]
                     if self.coupled and self.represent else [])

            def backward(group):
                """The pieces of one microbatch forward, then one backward:
                (each device's grads, the CE share, the aux, the loss
                share)."""
                mb = group[0][3]
                views: dict = {}
                whole: dict = {}

                def view(i):
                    if i not in views:
                        views[i] = tree_map(
                            lambda t: t.detach().requires_grad_(),
                            local_tree(params, i))
                    return views[i]

                def sink(i, name, g):
                    key = (i, name)
                    whole[key] = g if key not in whole else whole[key] + g

                chain = ExpertChain(cfg, bm * S) if self.coupled else None
                members = [(r, (start - mb * bm) * S, c * S)
                           for r, _, c, p_mb, start in every if p_mb == mb]
                rows_args, locals_ = [], []
                with torch.enable_grad():
                    for r, i, c, _, start in group:
                        sl = slice(i * c, (i + 1) * c)
                        local = {k: self._row_input(v, r)[sl]
                                 for k, v in batch.items()}
                        tp = self.tps[r]
                        if self.gathered:
                            tp = dataclasses.replace(tp, gather=RowGather(
                                self, params, r, sink))
                        if chain is not None:
                            tp = dataclasses.replace(
                                tp, experts=self.row_experts(
                                    r, view, (start - mb * bm) * S, chain,
                                    members))
                        rows_args.append((
                            [view(r * m + s) for s in range(m_run)],
                            local["inputs"], local["positions"], tp))
                        locals_.append(local)
                    outs = forward_rows(rows_args, cfg, mode="train",
                                        split_vocab=True)
                    parts = []
                    for (logits, aux), local, args in zip(outs, locals_,
                                                          rows_args):
                        part = self._nll(logits, local["targets"],
                                         local.get("mask"), args[-1])
                        parts.append(part / den[mb].to(part.device))
                    del outs, logits    # the backward keeps none of them
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
                out = {k: list(grads[n * per:(n + 1) * per])
                       for n, k in enumerate(keys)}
                for k in keys:
                    for j, name in gathered:
                        g = whole.get((k, name))
                        if g is None:           # a leaf this row never read
                            own = out[k][j]
                            shape = list(own.shape)
                            shape[self.gathered[name].dim] *= len(
                                self.gathered[name].peers[k][1])
                            g = own.new_zeros(shape)
                        out[k][j] = g
                return out, part.detach(), aux.detach(), total.detach()

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
            grads_d = self._reduce(acc, params, run, distinct, n_keys,
                                   grad_accum)
            # global norm: each region once (its first device's)
            pls = tree_leaves(self.param_placements)
            regions = self._regions(params)
            devs = [r * m + s for r in run for s in range(m_run)]
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
            # leaf lies over the rows too (the experts, params under fsdp),
            # over each block of rows holding one copy of the params
            blocks: dict = {}
            for r in run:
                base = r if self.represent else next(
                    b[0] for b in self.blocks if r in b)
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
                    spread=spread, row_group=(self.row_group
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

    def _reduce(self, acc: dict, params, run: list, distinct: list,
                n_keys: int, grad_accum: int) -> dict:
        """Every leaf's summed gradient on every running device, before
        the clip: summed over the distinct batch rows, then over the model
        shards that replicate it, in shard order; an expert leaf's over
        the rows holding the same slice only (its owners' grads hold every
        row's part already); a gathered leaf's as a replicated leaf's, each
        device keeping its slice (a reduce-scatter)."""
        m, m_run = self.m, self.m_run
        names = [n for n, _ in named_leaves(self.param_placements)]
        pls = tree_leaves(self.param_placements)
        regions = self._regions(params)
        ref = tree_leaves(local_tree(params, 0))
        devs = [r * m + s for r in run for s in range(m_run)]
        grads_d: dict[int, list] = {i: [] for i in devs}
        for j, pl in enumerate(pls):
            g = self.gathered.get(names[j])
            expert = g is None and _row_split(pl)
            split = m > 1 and any("model" in pl._dim_axes(k)
                                  for k in range(len(pl.spec)))
            nbytes = ref[j].numel() * 4
            if expert:
                group = self._replicas(regions[j])
                record_collective("all-reduce", nbytes,
                                  max(1, n_keys // len(self.owners[0])),
                                  m * len(self.owners[0]))
            elif g is not None:
                peers = g.peers[0][1]
                record_collective("reduce-scatter", nbytes, len(peers),
                                  peers[1] - peers[0])
                record_collective("all-reduce", nbytes,
                                  max(1, n_keys // len(peers))
                                  * (1 if split else m), m if split else 1)
            else:
                record_collective("all-reduce", nbytes,
                                  n_keys * (1 if split else m),
                                  m if split else 1)
            done: dict = {}
            for i in devs:
                r, s = divmod(i, m)
                shards = [s] if split else range(m_run)
                if expert:
                    reps = [q for q in group[r] if q * m + s in acc]
                    key = (regions[j][i], tuple(reps))
                    parts = lambda: self._grad_parts(acc, j, [s], reps)
                elif g is not None:
                    key = regions[j][i]
                    n = ref[j].shape[g.dim]
                    at = g.peers[i][0]
                    cut = (slice(None),) * g.dim + (slice(at * n,
                                                          (at + 1) * n),)
                    parts = lambda: self._scatter_parts(acc, j, shards,
                                                        distinct, cut)
                else:
                    key = s if split else None
                    parts = lambda: self._grad_parts(acc, j, shards,
                                                     distinct)
                if key not in done:
                    ps = parts()
                    # one part: a gathered leaf's slice in a buffer of its
                    # own (the whole gradient is freed)
                    total = ps[0].clone() if g is not None and len(ps) == 1 \
                        else ps[0]
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
        return grads_d

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


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` lies in ``b``'s storage (an update of it is one of
    ``b``'s)."""
    return a.device == b.device and (
        a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr())


def _rebuild(like, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)

