"""Dry run on the meta device: trace every (arch x shape) cell's sharded
program on the production mesh, prove memory fit, and extract roofline
terms.  Needs no card.

Port of the JAX package's ``launch/dryrun.py``.  Where the reference puts
512 placeholder CPU devices under XLA, lowers and compiles each cell
sharded by the rules and reads XLA's ``memory_analysis``,
``cost_analysis`` and the collectives in the HLO, this dry run puts 256 or
512 logical devices on ``torch.device("meta")``
(``mesh.logical_devices``), places the cell's params, optimizer state,
decode caches and batch on ``make_production_mesh`` by the port's rules
(``launch.spmd.Program``), runs the cell's sharded step once on meta
tensors under ``launch.costs.CostCounter`` and reads the program the port
really runs:

- ``argument_bytes``: per device, the bytes of its shards of every
  argument the step reads (placements alone: exact; an argument no op
  reads, such as mamba2's decode positions, is left out, as XLA's
  compiled program drops it);
- ``temp_bytes``: the most bytes the step had allocated at once on a
  device (outputs included), ``output_bytes`` those still live after it;
- ``flops`` (``torch.utils.flop_counter``'s formulas, and each kernel's
  own count from its meta route), ``bytes_accessed`` (every op's inputs
  and outputs: an upper bound, since eager ops do not fuse), and the
  collectives' bytes (the ring model of ``core.sharded.ring_bytes``).

One shard's program runs (row 0's first: on meta every shard has its
shapes), standing for every device; the reductions with the others are
recorded with the mesh's group sizes, and a gather takes the whole's
shape (``TensorParallel.group``).

Calibration has no counterpart: the reference corrects XLA's
``cost_analysis``, which counts a loop body once, by lowering unrolled
ladders (``corrected_costs``, ``_attn_chunk_topup``).  The counter here
sees every op of every layer it runs, remat's recompute included, so
``calibrate`` is accepted and ignored and ``calibrated`` is always false.

Hardware constants are the card's own: NVIDIA H100 80GB HBM3 (SXM), 700 W,
from NVIDIA's H100 data sheet.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Any

import torch

from repro_torch.configs.registry import (ARCH_IDS, SHAPES, Shape, all_cells,
                                          get_config)
from repro_torch.core.sharded import ShardedTensor, local_tree
from repro_torch.models import init_decode_caches, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import get_optimizer
from repro_torch.tree import tree_leaves

from .costs import CostCounter
from .mesh import Mesh, logical_devices, make_production_mesh
from .sharding import make_rules
from .spmd import Program

# ---------------------------------------------------------- hardware model
# NVIDIA H100 80GB HBM3 (SXM5), 700 W; NVIDIA H100 Tensor Core GPU data sheet
PEAK_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12           # HBM3 bytes/s per card
HBM_BYTES = 80e9           # device memory per card
NVLINK_BW = 450e9          # NVLink 4 B/s each way per card, within a host
IB_BW = 50e9               # 400 Gb/s InfiniBand NDR per card, across hosts
HOST_CARDS = 8             # cards one NVLink domain (an HGX host) joins
DEVICE = "NVIDIA H100 80GB HBM3, 700 W"


# ----------------------------------------------------------- input specs
def input_specs(arch_id: str, shape_name: str, *, multi_pod: bool = False,
                cfg: ModelConfig | None = None,
                shape: Shape | None = None) -> dict[str, Any]:
    """Meta-tensor stand-ins for every model input of a cell, with the
    reference's shapes and dtypes (no allocation)."""
    cfg = cfg or get_config(arch_id)
    shape = shape or SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    tok, emb = torch.int32, getattr(torch, cfg.dtype)
    if shape.kind == "train":
        inputs = (meta((B, S, cfg.d_model), emb)
                  if cfg.input_mode == "embeds" else meta((B, S), tok))
        return {"inputs": inputs, "targets": meta((B, S), tok),
                "positions": meta((B, S), tok),
                "mask": meta((B, S), torch.float32)}
    if shape.kind == "prefill":
        inputs = (meta((B, S, cfg.d_model), emb)
                  if cfg.input_mode == "embeds" else meta((B, S), tok))
        return {"inputs": inputs, "positions": meta((B, S), tok)}
    # decode: one new token against a seq_len cache
    inputs = (meta((B, 1, cfg.d_model), emb)
              if cfg.input_mode == "embeds" else meta((B,), tok))
    return {"inputs": inputs, "positions": meta((B, 1), tok)}


def model_flops(cfg: ModelConfig, shape) -> float:
    """6·N_active·D reference FLOPs for the cell (decode: D = batch
    tokens)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch      # one token per sequence


# ------------------------------------------------------------- the trace
def _device_bytes(args, n_devices: int, counter, returned=()) -> list[int]:
    """Each device's bytes of its shards of every ShardedTensor in
    ``args`` that the traced step read (on some shard: XLA drops an unused
    argument whole) or returns (a train step's state, Adafactor's unread
    momentum placeholders included: XLA keeps an argument its output
    aliases)."""
    out = [0] * n_devices
    kept = {id(leaf) for leaf in tree_leaves(returned)
            if isinstance(leaf, ShardedTensor)}
    for leaf in tree_leaves(args):
        if isinstance(leaf, ShardedTensor) and (id(leaf) in kept or any(
                map(counter.reads, leaf.shards))):
            for i, t in enumerate(leaf.shards):
                out[i] += t.numel() * t.element_size()
    return out


def collective_seconds(by_span: dict) -> float:
    """Seconds the recorded collectives take: a group within one host's
    NVLink domain at ``NVLINK_BW``, one that spans hosts at ``IB_BW``."""
    return sum(b / (NVLINK_BW if span <= HOST_CARDS else IB_BW)
               for span, b in by_span.items())


def trace(cfg: ModelConfig, mesh: Mesh, shape: Shape, *,
          rules: dict | None = None, grad_accum: int = 1,
          whole: bool = False) -> dict:
    """Place ``cfg``'s cell of ``shape`` on ``mesh`` (logical devices on
    meta) and run its sharded program once under the counter: row 0's
    first shard, standing for every shard (``whole``: every shard of every
    row, for the whole process's peak)."""
    rules = rules or make_rules(cfg, mesh, batch=shape.global_batch)
    t0 = time.monotonic()
    prog = Program(cfg, mesh, rules=rules, represent=not whole)
    rows = None if whole else [0]
    params = prog.place_params(init_params(cfg, device="meta"))
    specs = input_specs(cfg.name, shape.name, cfg=cfg, shape=shape)
    batch = prog.place_batch(specs)
    if shape.kind == "train":
        opt = get_optimizer(cfg.optimizer)
        state = prog.init_state(opt, params)
        step = prog.train_step(opt, grad_accum=grad_accum)
        args = (state, batch)
        run = lambda: step(state, batch, rows=rows)
    elif shape.kind == "prefill":
        args = (params, batch)
        run = lambda: prog.prefill(params, batch["inputs"],
                                   batch["positions"],
                                   max_len=shape.seq_len, rows=rows)
    else:
        caches = prog.place_caches(init_decode_caches(
            cfg, shape.global_batch, shape.seq_len, device="meta"))
        args = (params, caches, batch)
        run = lambda: prog.decode_step(params, caches, batch["inputs"],
                                       batch["positions"], rows=rows)
    t_place = time.monotonic() - t0
    counter = CostCounter()
    for s in range(prog.m):
        counter.mark(local_tree(args, s), s)
    t0 = time.monotonic()
    with counter:
        out = run()
    t_run = time.monotonic() - t0
    stats = counter.per_device()          # the outputs still live
    per_device = _device_bytes(args, mesh.size, counter, out)
    del out
    return {"prog": prog, "counter": counter, "args": per_device,
            "t_place": t_place, "t_run": t_run, **stats}


def _measure(arch_id: str, shape_name: str, *, multi_pod: bool,
             overrides: dict | None) -> dict:
    overrides = dict(overrides or {})
    rule_overrides = overrides.pop("_rules", None)   # sharding-rule overrides
    grad_accum = int(overrides.pop("_grad_accum", 1))
    cfg = get_config(arch_id)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    with logical_devices(512 if multi_pod else 256, "meta"):
        mesh = make_production_mesh(multi_pod=multi_pod)
    rules = make_rules(cfg, mesh, batch=shape.global_batch)
    if rule_overrides:
        for k, v in rule_overrides.items():
            rules[k] = tuple(v) if isinstance(v, list) else v
    out = trace(cfg, mesh, shape, rules=rules, grad_accum=grad_accum)
    out.update(cfg=cfg, chips=mesh.size)
    return out


def cell_file(arch_id: str, shape_name: str, *, multi_pod: bool,
              tag: str = "") -> str:
    suffix = ("_" + tag if tag else "") + ("_multipod" if multi_pod else "")
    return f"{arch_id}__{shape_name}{suffix}.json".replace("/", "_")


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
             out_dir: str, overrides: dict | None = None,
             tag: str = "", calibrate: bool = True) -> dict:
    """Trace one cell and write its JSON (the reference's keys and file
    name).  ``calibrate`` has no counterpart (see the module note)."""
    del calibrate
    full = _measure(arch_id, shape_name, multi_pod=multi_pod,
                    overrides=overrides)
    cfg, n_chips = full["cfg"], full["chips"]
    shape = SHAPES[shape_name]
    mf = model_flops(cfg, shape)
    flops, bytes_accessed = float(full["flops"]), float(full["bytes_accessed"])
    ledger = full["counter"].ledger
    coll = dict(ledger.bytes)
    arg = max(full["args"])
    result = {
        "arch": arch_id, "shape": shape_name, "multi_pod": multi_pod,
        "tag": tag, "chips": n_chips, "calibrated": False,
        "seconds": {"lower": round(full["t_place"], 1),
                    "compile": round(full["t_run"], 1)},
        "memory_analysis": {
            "argument_bytes": int(arg),
            "output_bytes": int(full["live_bytes"]),
            "temp_bytes": int(full["peak_bytes"]),
            "code_bytes": 0,
        },
        "cost_analysis": {"flops": flops, "bytes_accessed": bytes_accessed,
                          "raw_flops_uncorrected": flops,
                          "bytes_accessed_is": "upper bound: every eager "
                                               "op's inputs and outputs, "
                                               "no fusion"},
        "collective_bytes": coll,
        "roofline": {
            # per-device figures: terms are per-card step time
            "compute_s": flops / PEAK_FLOPS,
            "memory_s": bytes_accessed / HBM_BW,
            "collective_s": collective_seconds(ledger.by_span),
            "model_flops_global": mf,
            "useful_flops_ratio": (mf / n_chips) / flops if flops else 0.0,
        },
        "device": DEVICE,
        "fits": arg + full["peak_bytes"] <= HBM_BYTES,
        "ops": full["ops"],
        "kernel_flops": dict(full["counter"].kernel_flops),
        "rows_run": 1,
    }
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: result["roofline"][k])
    result["roofline"]["dominant"] = dom
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_file(
            arch_id, shape_name, multi_pod=multi_pod, tag=tag)), "w") as f:
        json.dump(result, f, indent=2)
    return result


# ----------------------------------------------------------------- CLI
UNCOVERED_EXIT = 3      # a cell that needs a stage the port has not reached


def sweep(args) -> int:
    """``--all``: every non-skipped cell in its own subprocess, cheapest
    first, recorded cells skipped; a cell that needs a stage the port has
    not reached is listed as uncovered.  Returns the exit code (1 if any
    cell failed)."""
    jobs = []
    size_rank = {a: get_config(a).param_count() for a in ARCH_IDS}
    kind_rank = {"decode": 0, "prefill": 1, "train": 2}
    for cell in all_cells():
        if cell.skipped:
            print(f"SKIP {cell.name}: {cell.skip_reason}", flush=True)
            continue
        for mp in ([False, True] if args.both_meshes else [args.multi_pod]):
            jobs.append((cell, mp))
    # cheapest first: decode < prefill < train, small models first,
    # single-pod before multi-pod
    jobs.sort(key=lambda j: (kind_rank[j[0].shape.kind],
                             size_rank[j[0].arch_id], j[1]))
    failures, uncovered, running = [], [], []

    def finish(cell, mp, proc, t0):
        out, err = proc.communicate()
        last = out.strip().splitlines()[-1] if out.strip() else ""
        if proc.returncode == UNCOVERED_EXIT:
            uncovered.append((cell.name, mp, last))
        elif proc.returncode != 0:
            failures.append((cell.name, mp, err[-2000:]))
            print(f"FAIL {cell.name}: {err[-500:]}", flush=True)
            return
        print(f"  [{time.time() - t0:5.0f}s] {last}", flush=True)

    for cell, mp in jobs:
        fname = cell_file(cell.arch_id, cell.shape.name, multi_pod=mp,
                          tag=args.tag)
        if os.path.exists(os.path.join(args.out, fname)):
            print(f"HAVE {cell.name} multi_pod={mp}", flush=True)
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", cell.arch_id, "--shape", cell.shape.name,
               "--out", args.out]
        if mp:
            cmd.append("--multi-pod")
        for ov in args.override:
            cmd += ["--override", ov]
        if args.tag:
            cmd += ["--tag", args.tag]
        while len(running) >= max(1, args.jobs):
            finish(*running.pop(0))
        print(f"RUN  {cell.name} multi_pod={mp}", flush=True)
        running.append((cell, mp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            time.time()))
    while running:
        finish(*running.pop(0))
    print(f"\n{len(uncovered)} UNCOVERED")
    for name, mp, line in uncovered:
        print(f"--- {name} mp={mp}: {line}")
    if failures:
        print(f"\n{len(failures)} FAILURES")
        for name, mp, err in failures:
            print(f"--- {name} mp={mp}\n{err}\n")
        return 1
    print("\nALL COVERED CELLS PASS")
    return 0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every cell in subprocesses")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field=value overrides (e.g. moe_impl=scatter)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all: cells traced at once")
    args = ap.parse_args()

    if args.all:
        sys.exit(sweep(args))

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    try:
        res = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                       out_dir=args.out, overrides=overrides or None,
                       tag=args.tag)
    except NotImplementedError as e:
        print(f"UNCOVERED {args.arch}@{args.shape} mp={args.multi_pod}: {e}")
        sys.exit(UNCOVERED_EXIT)
    r = res["roofline"]
    print(f"{args.arch}@{args.shape} mp={args.multi_pod} "
          f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
          f"collective={r['collective_s']:.4f}s dominant={r['dominant']} "
          f"useful={r['useful_flops_ratio']:.2f} "
          f"temp={res['memory_analysis']['temp_bytes']/2**30:.2f}GiB")


if __name__ == "__main__":
    main()
