#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout (one
``nvcc`` per source, in parallel), then runs these phases in order, failing
on the first phase that fails (exit code != 0):

1. env          — the card (nvidia-smi name and power limit), torch and
                  CUDA versions, the kernels' build time.
2. kernel       — K1, the ragged paged-attention kernel: first what the
                  compiler made of its tensor-core kernel (ptxas registers,
                  stack, spills; mma.sync count in SASS), then against its
                  plain PyTorch version on the card at gemma2-9b's attention
                  shapes (H=16, K=8, D=256, block 16, 512 packed lanes mixing
                  decode rows with contexts past the 4096 window, prefill
                  chunks, speculative verify rows and pad lanes), at pool
                  dtypes float32, bfloat16, int8 and fp8_e4m3, window None /
                  4096, softcap None / 50, each case with the route the
                  library took (a bf16 q over a bf16, int8 or fp8 pool must
                  take the tensor cores) and its segment count; plus
                  exact-zero pad lanes, bit-invariance to -1 table widening,
                  k=0 verify rows bit-matching one-token decode, and every
                  lane bit-equal under three other packings of the same
                  lanes (rows reordered, chunks cut at other offsets, verify
                  runs taken apart); then bf16 pools at the
                  h2o-danube widths (H=32, K=8, D=80 and D=120), each at its
                  config's window, and at the MoE configs' (D=128:
                  deepseek-moe-16b H=K=16, llama4-maverick H=40, K=8), no
                  window; then the serve phase's decode tick (8
                  decode rows, one at 4,532 positions, padded to 512 lanes)
                  with bf16 and int8 pools.  Times: kernel and plain version
                  (CUDA events, median, cold L2), and the bound (bytes and
                  operations the work needs at least, over the card's
                  published peaks); each case's span count and workspace
                  bytes.
3. flash_kernel — K2, the flash-attention kernel: first what the compiler
                  made of it (ptxas registers, shared memory and spills of
                  each instantiation; HGMMA instructions in its SASS), then
                  against its plain version: gemma2-9b's shapes (B=1,
                  S=8192, H=16, K=8, D=256) in f32
                  and bf16 with window None / 4096 and softcap None / 50, one
                  case at each other config's shapes and window (zamba2-2.7b:
                  D=160, H=K=32; deepseek-moe-16b: D=128, H=K=16;
                  llama4-maverick: D=128, H=40, K=8), a ragged S=8000, and
                  zamba2-2.7b's dense
                  prefill shapes (4 x 2048, 17, 300); bf16 outputs held
                  element by element to one rounding from the plain version's
                  f32 values; times as for K1, plus one library call
                  computing the same function (library_ms:
                  scaled_dot_product_attention, causal or with a band mask,
                  or compiled flex_attention where there is a softcap; the
                  port never calls them); the embeds configs' shapes
                  (H=K=32, D=64 and 96) at S=8192 and at each (B, S) the
                  embeds phases send (4 x 2048, 4500, 1000, 300, 17,
                  8 x 1000, 8 x 1032).
4. ssd_kernel   — K3, the SSD chunked scan: first what the compiler made of
                  its stage kernels (ptxas registers, stack, spills; HMMA
                  count in SASS, which the chunk scan must have), then
                  against its plain version at mamba2-1.3b's shapes (H=64,
                  P=64, N=128, chunk 256; S=4500, 4 x 2048, 17, and the score
                  forward's 8192) and zamba2-2.7b's (H=80, N=64), in bf16
                  and f32, with and without h0 and the D-term; y and h_final
                  within 5e-4 + 1e-3 |plain| element by element, and the same
                  bits from two calls; each case's route (bf16 must take the
                  tensor cores) and workspace bytes, and each shape's stage
                  split from one profiled call; times as for K1 (no library
                  call computes the scan).
5. decode_kernel — K4, dense decode attention, against its plain version:
                  zamba2-2.7b's shared attention (8 rows of 8192 slots,
                  H=K=32, D=160, filled to 49..8192) in bf16 and f32, and
                  gemma2-9b's local layer (a 4096-slot ring wrapped past its
                  size, window 4096) and global layer (8192 slots), softcap
                  50, at every cache dtype; llama4-maverick's widths (H=40,
                  K=8, D=128: G=5) in bf16 and int8 and h2o-danube-1.8b's
                  (H=32, K=8, D=80: G=4) on a 4096 ring; a row with nothing
                  visible; the embeds configs' MHA (8 rows of 8192 slots,
                  H=K=32, D=64 and 96); times as for K2 (library: SDPA with
                  a mask of the invisible slots, or compiled
                  flex_attention), and each case's span count and
                  workspace bytes.
6. score_check  — gemma2-9b at full width cut to 2 layers: ``forward`` with
                  K2 against the same forward with the plain attention on
                  2048 tokens, and ``forward``'s logits on a 512-token prompt
                  against ``paged_mixed_step`` prefilling it as one packed
                  chunk (K2 and K1 computing one attention).
7. ssm_check    — mamba2-1.3b cut to 2 layers and zamba2-2.7b cut to one
                  group (6 mamba + 1 shared attention) at full width: the
                  last logits of ``forward`` over 1001 tokens against
                  ``prefill`` over 1000 then ``decode_step`` (K3's state,
                  the conv window and K4 carrying the context).  Then, for
                  ROADMAP W1 (informational), the mamba2 check again with
                  f32 weights and activations and with K3's plain version,
                  and K3's own error on that model's inputs.
8. model        — one packed step of the 2-layer gemma2-9b, with K1
                  against the same step with the plain attention.
9. serve        — ``ServeEngine`` serving gemma2-9b (CONFIG: full width, all
                  42 layers, bf16, seeded random weights) 8 requests: one
                  4500-token prompt chunked over several ticks across the
                  4096 window, seven of 16-300 tokens (two share a 64-token
                  prefix), 32 greedy new tokens each, with the tick
                  captured as a CUDA graph (the engine's default).  Then
                  eagerly (``cuda_graphs=False``) and captured again, with
                  speculative decoding (spec_k=2), with an int8 pool
                  captured and eagerly, and three requests sampled at
                  temperature 1 (spec_k=2) captured and eagerly: the greedy
                  streams of every bf16 run must be identical, the int8
                  runs' streams equal, and the sampled runs' too.  Every
                  run goes under ``torch.cuda.set_sync_debug_mode("error")``
                  outside the engine's one pull per tick.  Asserts
                  host_syncs == ticks, K1 launches == ticks x 42 (a replay
                  adds its capture's counts), one capture per captured
                  engine and a replay at every tick after the first, and
                  that deleting the engine frees its graph.
10. trace       — the main serve run again under torch.profiler, captured
                  and eagerly: device time by kernel, the device's idle
                  share, and K1's launches by its wrapper's count (==
                  ticks x 42) and as the trace counts them (at most 1 % of
                  the records dropped, ``records_dropped``; a run that
                  dropped more is run again, at most three runs).  Then
                  one ``graphs`` line: captured against
                  eager (TTFT p50, TPOT p50, tokens/s, peak memory, idle
                  share).
11. serve_dense — ``ServeEngine(paged=False)`` serving mamba2-1.3b and
                  zamba2-2.7b (full width and depth, bf16, seeded weights,
                  8 slots of 8192) 8 requests: four of 2048 tokens (one
                  batched prefill), 4500, 17, 300 and 1000, 32 greedy new
                  tokens each, the decode tick captured; then eagerly and
                  captured again (equal streams), two requests sampled
                  captured and eagerly (equal streams), all under the sync
                  check.  Asserts host_syncs == decode_ticks +
                  prefill_batches with 5 prefill batches, K3 launches ==
                  mamba layers x prefill_batches, K2 and K4 launches ==
                  shared-attention applications x prefill_batches and x
                  decode_ticks, one decode capture per captured engine and
                  a replay at every decode tick after the first; then each
                  model under torch.profiler, captured and eagerly (the
                  wrappers' counts held again, and K3's and K4's counted in
                  the trace too, at most 1 % of them dropped), and its
                  ``graphs`` line.
12. preempt     — gemma2-9b at full width and depth, bf16, captured ticks,
                  8 slots, 512-token budget, prefix cache off: six batch
                  requests (900-token prompts, 64 greedy tokens) ticked
                  until each decodes, then one interactive request (1,500
                  tokens, 32), four ways: (a) 1,024 blocks, no pressure;
                  (b) 400 blocks with ``preempt=True`` and a SpillPool
                  backed by a host CascadeStore pool ``/spill/gemma2-9b``
                  (victims resume by ``adopt``); (c) 400 blocks with a
                  standalone SpillPool of 32 blocks, which refuses every
                  park (victims replay); (d) 400 blocks without
                  preemption.  Every stream of (b), (c) and (d) equals
                  (a)'s; (b) preempts and resumes at least twice, each
                  resume an adoption; (c) resumes none; host_syncs ==
                  ticks + spill_syncs; K1 launches == ticks x 42; the
                  allocator drains exactly; no pool leaf is rebound; all
                  under the sync check.  Prints the interactive TTFT of
                  each run and every spill's and adoption's bytes, ms and
                  GB/s.
13. failover_and_steps — engine A serves the six batch requests; a seeded
                  FaultInjector crashes it at a tick entry once they
                  decode; ``evacuate(spill_kv=True)`` and ``adopt`` on
                  engine B (same params, its own pool): the streams equal
                  (a)'s, A keeps host_syncs == ticks + spill_syncs and B
                  host_syncs == ticks.  Then ``paged_prefill`` of four
                  1,000-token prompts and 16 ``paged_decode_step``s at full
                  depth: K1 42 times a step, the first-token logits within
                  2e-2 x scale of ``paged_mixed_step`` packing the same
                  prompts as the engine does, K1's workspace bytes before
                  and after; at f32 cut to 4 layers, the greedy streams
                  equal the engine's.
14. cluster     — Cascade's serving layer, bf16, captured ticks, all
                  under the sync check (a node's upcall threads included;
                  an upcall that raises fails the drain at once).  First
                  ``ServeCluster(gemma2-9b, n_replicas=1)`` on the serve
                  phase's eight requests: the direct engine's captured
                  greedy streams bit for bit, host_syncs == ticks, K1
                  launches == ticks x 42, TTFT / TPOT p50 beside the direct
                  engine's and the queue wait from client submit to issue.
                  Then one ``ServeNode(n_workers=2)`` hosting h2o-danube-1.8b
                  (paged, 2 replicas, FIFO sessions, 8 slots of 8192, budget
                  512, 1,024 blocks) and zamba2-2.7b (dense, 2 replicas, 4
                  slots of 4096), which share a 32,000-token vocabulary:
                  three chat sessions x three turns (64 -> ~300 tokens, 16
                  new each; each session on one replica, prefix hits), a
                  probe pass and a ``CascadeRoute`` over 16 prompts of
                  128-1000 tokens (32 new) whose logprob gate sits at the
                  probe's median (0 < escalation rate < 1), a burst of 24
                  over a watermark of 2 (redirects, sheds answered by the
                  heavy tier, none lost), and a seeded crash of light replica
                  1 mid-drain (its KV adopted on replica 0).  A client
                  request arrives inside every capture of every replica's
                  tick.  Checks each tier's sync invariant, K1 == light
                  ticks x 24, K2 / K3 == 9 / 54 x heavy prefill batches, K4
                  == 9 x heavy decode ticks, every light and escalated
                  stream against a direct engine's, each ``/kv`` key's
                  version == ticks + adoptions with the engine's own pool
                  tensors stored (no donate miss); then the light tier's
                  ``stop()`` leaves no ``/kv/light`` key and, once its
                  engines and the store's read cache let go, the memory
                  falls by at least its two pools.
15. mesh        — gemma2-9b at full width and depth, bf16, on the serve
                  traffic and 1,024 blocks: a one-device slice of a
                  ``ServeNode`` deployment (``devices_per_replica=1``),
                  then a model-2 slice of two logical devices on the card
                  (``logical_devices(2, dev)``), captured and eagerly: K1
                  == ticks x 84 (local H 8, K 4, D 256), host_syncs ==
                  ticks, no donate miss, no allocation growth after the
                  capture, captured bit-equal to eager, TPOT p50 of each
                  run.  The model-2 first tick again, directly, with each
                  of its 84 reductions within half a bf16 ulp of the f64
                  sum of the shards' parts, and a control whose combine
                  rounds each part first, which must fail that; the first
                  tick's logits of the one device, the model-2 slice and
                  the control against the same weights in f32 (reported:
                  bf16 rounding at 42 layers hides the control there);
                  the first tick's argmax equal to the one device's;
                  greedy tokens equal before a first difference.  Then full width cut to 4
                  layers at f32: the model-2 streams equal the one
                  device's; an int8 spill off a model-2 slice adopted on
                  a one-device slice round-trips bit for bit and its
                  stream goes on as the uninterrupted one.  K1 at the shard widths (H 8 /
                  K 4, H 4 / K 2, H 2 over kv head 2 of a 4-head pool read
                  in place) against its plain version, bf16 and int8; and
                  ``elastic_reshard`` of a zamba2-2.7b AdamW state (cut to
                  6 layers) to a (1, 2) mesh and back, bit-equal.
16. serve_moe   — ``ServeEngine`` serving deepseek-moe-16b (CONFIG: full
                  width, all 28 layers, 27 of them MoE with 64 routed
                  experts top-6 and 2 shared, bf16, seeded weights, 32.75
                  GB) the serve phase's 8 requests on 8 slots, a 512-token
                  budget and 1,024 blocks of 16: captured, eagerly and
                  captured again (equal streams), and at spec_k=2 (its
                  streams against spec_k=0's reported, not asserted:
                  capacity makes a token's output depend on the other
                  tokens of its tick), all under the sync check; asserts
                  host_syncs == ticks and K1 launches == ticks x 28; then
                  one captured run traced (device time in K1, gemm and an
                  approximate moe_dispatch group), and one tick's share of
                  (token, slot) entries that capacity drops.
17. moe_check   — llama4-maverick-400b-a17b at full width cut to one period
                  of its pattern (n_layers 48 -> 2: a dense and a MoE layer
                  of 128 experts, 37.1 GB): ``forward`` on 2048 tokens with
                  K2 against the plain attention (the tokens both runs route
                  alike held within 2e-2 of the logits' scale, at least 0.9
                  of them), then three requests served captured and eagerly
                  (equal streams, K1 launches == ticks x 2).
18. embeds      — musicgen-large and phi-3-vision-4.2b (full width and
                  depth, bf16, seeded weights, N(0, 1) f32 input
                  embeddings), one at a time.  score_embeds: ``forward``
                  over B=1, S=8192 (K2 == n_layers; wall s, tokens/s, peak
                  memory).  embeds_check: ``prefill`` of 1000 embeddings
                  over 8 slots of 8192, 32 ``decode_step``s (K4 ==
                  n_layers x 32), the prefill's and the last step's logits
                  within 2e-2 of the scale of ``forward``'s over the same
                  1032.  serve_embeds: the dense ``ServeEngine`` (8 slots
                  of 8192) on the serve_dense lengths as (S, d) prompts,
                  one token each: first tokens == a direct prefill's
                  argmax, host_syncs == prefill_batches == 5, K2 ==
                  n_layers x 5, TTFT p50 / p99, and a 4-token request
                  rejected naming ROADMAP F12.  musicgen-large then through
                  ``ServeCluster(n_replicas=1)`` (4 slots of 4608): answers
                  == a direct engine of that shape, the queue wait, F12
                  through the store.  phi-3-vision-4.2b then drives the
                  device fast path (``core/fastpath.py``): three light
                  stages on a (1, 2048, 3072) bf16 activation fused (one
                  CUDA graph), chained and brokered, 200 runs each,
                  bit-equal, p50 / p99 a run, the hop alone and the
                  brokered run over the chained one per hop; ten fused
                  calls under torch.profiler are ten graph launches and
                  no kernel launch; the donation contract; a capture
                  cache of two graphs evicting the first of three shapes
                  without holding more memory; then a frontend
                  into the full backbone chained, brokered and fused:
                  bit-equal logits, the hop's share.
19. score       — ``forward`` at full width and full depth, bf16, seeded
                  random weights, B=1: gemma2-9b, gemma3-4b, h2o-danube-1.8b,
                  mamba2-1.3b, zamba2-2.7b and deepseek-moe-16b at S=8192,
                  h2o-danube-3-4b at S=9216 (past its 8192 window); finite
                  f32 logits of shape (1, S, V), K2 launches == attention
                  layers and K3 launches == mamba layers per forward, the
                  aux loss >= 1 - 1e-3 with experts and 0 without; wall
                  time, tokens/s, peak memory.
20. score_trace — one gemma2-9b score forward under torch.profiler
                  (informational).
21. grad_kernel — (after dropping the libraries' caches and checking that
                  no earlier phase left device memory allocated: no CUDA
                  tensor outside the kernels' workspaces, at most 4 MiB of
                  library state) K2 and K3
                  under autograd at zamba2-2.7b's training shapes (K2: B 2,
                  S 2048, H = K = 32, D 160; K3: H 80, P 64, N 64, chunk
                  256; bf16): the Function's forward bit-equal to a direct
                  kernel call, two calls bit-equal, one launch per forward,
                  its grads bit-equal to the plain version's autograd grads;
                  forward and backward times.
22. train_check — zamba2-2.7b at full width cut to 6 layers (one group),
                  B 1 x S 2048: the loss and every gradient leaf with the
                  kernels against the plain versions swapped into the
                  wrappers' CUDA route; f32: loss within 1e-5 relative,
                  each leaf within 2e-4 of its max-abs; bf16: the global
                  gradient norm within 2e-2 relative, every leaf's cosine.
23. train       — zamba2-2.7b at full width and depth, bf16, AdamW (lr
                  1e-3, warmup 1), max_grad_norm 1, remat, B 2 x S 2048, 6
                  steps: finite losses and norms, the last loss below the
                  first, K2 == 18 and K3 == 108 launches a step, peak
                  memory under 60 GB; step time p50, tokens/s and the
                  step's share of its model-FLOPs bound.
24. train_ft    — zamba2-2.7b cut to 6 layers, Adafactor, B 1 x S 1024,
                  ``FaultTolerantLoop`` over a ``CheckpointManager`` in a
                  temporary directory, checkpoints at steps 2 and 3 (bytes,
                  seconds): a new loop resumes at step 3 bit for bit, the
                  next step's loss bit-equal from both states, a
                  time-travel restore returns step 2.
25. sharded     — the sharded programs of ``launch.spmd`` on logical
                  devices of the card, full width and depth, bf16:
                  h2o-danube-1.8b's AdamW train step on (data 2, model 2),
                  global batch 4 x 4,096, 3 steps; zamba2-2.7b's prefill of
                  2 x 4,096 and 32 decode steps on (data 1, model 2).  Each
                  split reduction within ``MESH_COMBINE_ULPS`` of the f64
                  sum of its parts, a control (parts rounded first) that
                  must exceed it; the loss and logits against the same
                  program on one logical device within the stated bf16
                  bounds (``SHARDED_*``), greedy tokens equal wherever the
                  one-device margin clears them; K2, K3 and K4 launches
                  exactly (per shard per layer, x2 under remat); the bytes
                  the placed arguments hold equal to the dry run's trace of
                  the same mesh and shapes on meta; no program faster than
                  that trace's roofline bound; the trace's peak reported
                  beside ``max_memory_allocated``.  Then ``sharded_moe``
                  (Stage 5: the experts over 'data'): deepseek-moe-16b at
                  full width and depth, bf16, on (data 2, model 2), one
                  device's run first (logits and routing kept on the host,
                  its params then placed leaf by leaf): a prefill of 4 x
                  2,048, 16 decode steps and a prefill of 4 x 120 (one
                  group of 480 over both rows, with drops), the checks
                  above but the logits' (K2 = 28 x 4 a prefill, K4 = 28 x
                  4 a step): bf16 at 28 MoE-routed layers is chaotic, so
                  the MoE inputs are held layer by layer within twice the
                  drift of two one-device runs that differ only in
                  attention rounding, and the logits, the routing choices
                  that differ per layer and the dropped share reported;
                  its first 4 layers upcast to f32, every routing choice
                  equal (but at near-ties) and the logits within 1e-3 of
                  the scale; AdamW steps cut to 3 layers (B 4 x 2,048, 3
                  steps) against one device's, the aux loss within 1e-2.
26. dryrun      — ``python -m repro_torch.launch.dryrun --all`` on the
                  card's host (single-pod mesh, ``DRYRUN_JOBS`` cells at
                  once, its own time limit): one line per cell; every cell
                  wrote its JSON, none uncovered.
27. examples    — the six twins of ``examples/*.py`` in
                  ``examples_torch/`` (quickstart, smart_farming,
                  collision_detection, serve_lm, serve_cluster, train_lm),
                  each run in this process at its defaults on the card
                  (``runpy``, its kernel counts set to 0 just before):
                  each must print ``OK`` last; K1 launches > 0 in serve_lm
                  and serve_cluster, K3 in serve_cluster, K2 (under
                  autograd) in train_lm.  First K1 (gemma2-9b SMOKE: H 4,
                  K 2, D 16, f32, window 8 and none, softcap 50, a 32-lane
                  tick), K2 (train_lm's lm100m: B 8 x S 256, H 8, K 4, D
                  64, f32) and K3 (mamba2-1.3b SMOKE: H 8, P = N = 16,
                  chunk 8, f32) against their plain versions at those
                  shapes.  Budget 120 s; no tensor the twins made may
                  stay reachable.

It prints one JSON line per phase, then each phase's seconds, then the
card's name and power limit as nvidia-smi gives them, then the kernels line
(K1-K4, with K1's launches per model-2 tick and its shard-width cases,
K2's and K3's launches per train step and their autograd times, K2's, K3's
and K4's launches in the sharded programs, K2's and K4's with the experts
over 'data', and each kernel's launches in each twin), and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import weakref
from pathlib import Path

import numpy as np
import torch

MEM_BW = 3.35e12                  # H100 SXM HBM3 bytes/s (data sheet)
PEAK = {torch.bfloat16: 989e12,   # dense tensor-core bf16 FLOP/s
        torch.float32: 67e12}     # f32 outside the tensor cores
GEMM_KEYS = ("gemm", "nvjet", "cutlass", "xmma")   # cuBLAS kernel names
K1_TPU = "src/repro/kernels/decode_attention/kernel.py:283"
K1_SRC = "src/repro_torch/kernels/csrc/ragged_paged_attention.cu"
BOUND_FORMULA = (
    "max(bytes / 3.35e12 B/s, flops / peak[q dtype]); bytes = unique K/V "
    "blocks visible to some token x bs*K*(2*D*kv_itemsize + 8 if scaled) + "
    "2*T*H*D*q_itemsize + 4*(R*nb + 2*T); flops = 4*D*H per visible (token, "
    "position); peak 989e12 (bf16 tensor cores) or 67e12 (f32)")
# K1's kernels by name in a profiler trace: the tensor-core kernel and its
# plan, the span kernels and the combine
K1_KERNELS = ("ragged_tc_kernel", "ragged_tc_plan_kernel",
              "ragged_span_kernel", "ragged_wide_kernel",
              "ragged_combine_kernel")
LIBRARY_NOTE = ("none: no single PyTorch call attends each packed token over "
                "its own request's blocks of a paged pool")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, flush: torch.Tensor | None = None) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events around
    each run; ``flush`` is rewritten before each so the 50 MB L2 is cold, as
    the served path finds it after the other layers' traffic)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


ROUND_BF16 = 2.0 ** -8   # half a bf16 spacing, relative to the value
F32_TOL = 2e-5           # the JAX suite's f32 tolerance


def checked_case(kernel, plain, tol, nbytes, flops, peak_dtype, flush, reps,
                 plain32=None, **fields) -> tuple[dict, torch.Tensor]:
    """Run ``kernel`` and its ``plain`` version once and hold them within
    ``tol``; then time both (``reps`` = kernel and plain repetitions, cold
    L2) beside the bound: the larger of ``nbytes`` over the memory rate and
    ``flops`` over the peak of ``peak_dtype``.  Returns the case and the
    kernel's output.

    For a bf16 output ``plain32`` is the plain version on the same inputs
    widened to f32: the f32 value the kernel computes before its one
    rounding to bf16.  Each output element must then lie within half a
    bf16 spacing of it (at most 2^-8 of its size) plus the f32 tolerance:
    ``err_over_rounding_bound`` (<= 1) is the largest ratio of an element's
    error to that bound.  A row of small outputs is held as tightly as one
    of large ones, which an absolute tolerance does not do."""
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    assert err <= tol, (fields, err, tol)
    del want
    if plain32 is not None:
        want32 = plain32()
        over = ((out.float() - want32).abs()
                / (want32.abs() * ROUND_BF16 + F32_TOL)).max().item()
        assert over <= 1.0, (fields, "err_over_rounding_bound", over)
        fields = dict(fields, err_over_rounding_bound=over)
        del want32
    t_bytes, t_ops = nbytes / MEM_BW * 1e3, flops / PEAK[peak_dtype] * 1e3
    case = dict(fields, max_abs_err=err, tol=tol,
                kernel_ms=cuda_ms(kernel, reps[0], flush),
                plain_ms=cuda_ms(plain, reps[1], flush),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)
    return case, out


# ================================================================= kernel
# (ctx, fed): the row's tokens are the last ``fed`` positions of ``ctx``
KERNEL_ROWS = [(5200, 1), (4097, 1), (2000, 1), (700, 1), (64, 1),   # decode
               (4500, 300), (120, 120),                       # prefill chunks
               (3000, 3), (800, 2)]                           # verify rows
H, KV, D, BS, T = 16, 8, 256, 16, 512
# the serve phase's decode tick: its 8 rows' contexts after their prompts
# and 32 new tokens (one row past the 4096 window), one token each, padded
# to the tick's T = 512 lanes
DECODE_TICK_ROWS = [(4532, 1), (196, 1), (332, 1), (152, 1), (48, 1),
                    (109, 1), (332, 1), (63, 1)]
# K1 at the h2o-danube widths (head_dim 80 and 120) and the MoE configs'
# (head_dim 128: deepseek-moe-16b's MHA, G = 1, and llama4-maverick's G = 5),
# bf16 pool, the config's own window: (arch, H, K, D, window)
K1_WIDTHS = [("h2o-danube-1.8b", 32, 8, 80, 4096),
             ("h2o-danube-3-4b", 32, 8, 120, 8192),
             ("deepseek-moe-16b", 16, 16, 128, None),
             ("llama4-maverick-400b-a17b", 40, 8, 128, None)]


def kernel_inputs(dev, rng, h=H, kv=KV, d=D, reqs=KERNEL_ROWS, lanes=T):
    n_blocks = [-(-c // BS) for c, _ in reqs]
    N = 1 + sum(n_blocks) + 2
    nb = max(n_blocks)
    bt = np.full((len(reqs), nb), -1, np.int32)
    perm = rng.permutation(np.arange(1, N))
    i = 0
    for r, n in enumerate(n_blocks):
        bt[r, :n] = perm[i:i + n]
        i += n
    rows = np.full(lanes, -1, np.int32)
    pos = np.full(lanes, -1, np.int32)
    n = 0
    for r, (ctx, fed) in enumerate(reqs):
        rows[n:n + fed] = r
        pos[n:n + fed] = np.arange(ctx - fed, ctx)
        n += fed
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    q = torch.randn((lanes, h, d), generator=g, device=dev)
    k = torch.randn((N, BS, kv, d), generator=g, device=dev)
    v = torch.randn((N, BS, kv, d), generator=g, device=dev)
    to = lambda a: torch.from_numpy(a).to(dev)
    return q, k, v, to(bt), to(rows), to(pos), n, bt, rows, pos


def work(bt, rows, pos, window, kv_item, q_item, quant, h=H, kv=KV, d=D):
    """Bytes and operations the function needs at least on these inputs:
    every K/V block visible to at least one token, read once for all kv
    heads (plus its scales), q read and out written once, the index
    operands once; two products of 2·D flops per visible (token, head,
    position).  K1's own count (``ops.ragged_work``), which its meta route
    also reads."""
    from repro_torch.kernels.decode_attention.ops import ragged_work

    return ragged_work(bt, rows, pos, window, BS, h, kv, d, kv_item, q_item,
                       quant)


def k1_spans(T_, kv, g, d, nb) -> dict:
    """K1's span axis and workspace at these shapes (the span plan of
    ``ref.py``, which mirrors ``split_kv.cuh``)."""
    from repro_torch.kernels.decode_attention import ref

    n = ref.n_spans(nb, ref.K1_SPAN_BLOCKS)
    return {"span_blocks": ref.K1_SPAN_BLOCKS, "n_span": n,
            "workspace_bytes": 4 * ref.workspace_elems(T_, kv, n, g, d)}


def k1_route(q, kp, bt, rows, pos, window) -> dict:
    """Which K1 kernel the compiled library takes for these tensors, and,
    on the tensor-core route, how many segments the plan makes of the
    packing (``ref.ragged_segment_plan``, which mirrors the plan kernel).
    A bf16 q over a bf16, int8 or fp8 pool must take the tensor cores."""
    from repro_torch.kernels.decode_attention import ops, ref

    route = ops.ragged_paged_attention_route(q, kp)
    if q.dtype == torch.bfloat16 and kp.dtype != torch.float32:
        assert route == "tensor_core", (q.dtype, kp.dtype, route)
    segs = (len(ref.ragged_segment_plan(
        bt.cpu(), rows.cpu(), pos.cpu(), G=q.shape[1] // kp.shape[2],
        bs=kp.shape[1], window=window)) if route == "tensor_core" else None)
    return {"route": route, "segments": segs}


def repackings(rows_np, n_valid) -> list[tuple[str, list[int]]]:
    """Three other packings of the T = 512 mixed case's valid lanes, each
    as the list of original lanes at its new lanes (-1: a pad lane), padded
    to T: (1) the rows in another order with a pad lane after each; (2)
    the two prefill chunks cut at lane offsets that are not multiples of a
    segment, their pieces interleaved with the other rows; (3) the verify
    rows' runs taken apart into one-lane entries, as decode lanes would
    come, placed between other rows."""
    runs: dict[int, list[int]] = {}
    for t in range(n_valid):
        runs.setdefault(int(rows_np[t]), []).append(t)
    rows = list(runs)
    by_len = sorted(rows, key=lambda r: -len(runs[r]))
    chunk_a, chunk_b = by_len[0], by_len[1]
    short = [r for r in rows if 1 < len(runs[r]) < len(runs[chunk_b])]
    singles = [r for r in rows if len(runs[r]) == 1]
    pad = lambda order: order + [-1] * (T - len(order))
    one = []
    for r in rows[::-1][1::2] + rows[::-1][0::2]:
        one += runs[r] + [-1]
    a, b = runs[chunk_a], runs[chunk_b]
    two = (a[:37] + runs[singles[0]] + b[:13] + a[37:101] + runs[short[0]]
           + a[101:170] + b[13:50] + runs[singles[1]] + a[170:] + b[50:])
    two += [t for r in rows if r not in (chunk_a, chunk_b, singles[0],
                                         singles[1], short[0])
            for t in runs[r]]
    three = []
    for r in rows:
        if r in short:
            continue
        three += runs[r]
    for i, r in enumerate(short):
        for j, t in enumerate(runs[r]):
            three.insert(1 + 40 * i + 97 * j, t)
    for order in (one, two, three):
        assert sorted(t for t in order if t >= 0) == list(range(n_valid))
    return [("rows_reordered", pad(one)), ("chunks_split", pad(two)),
            ("runs_taken_apart", pad(three))]


def repack_contract(q, kp, vp, bt, rows, pos, n_valid, rows_np, kw) -> dict:
    """K1's output, lane for lane, under the three ``repackings`` of the
    mixed case: each lane's bits must not depend on the lanes beside it,
    where its segment starts, or its index.  Returns each packing's segment
    count."""
    from repro_torch.kernels.decode_attention import ops, ref

    base = ops.ragged_paged_attention(q, kp, vp, bt, rows, pos, **kw)
    dev = q.device
    segments = {}
    for name, order in repackings(rows_np, n_valid):
        idx = torch.tensor([max(t, 0) for t in order], device=dev)
        live = torch.tensor([t >= 0 for t in order], device=dev)
        q2 = torch.where(live[:, None, None], q[idx], torch.zeros_like(q[idx]))
        neg = torch.full_like(rows[idx], -1)
        r2 = torch.where(live, rows[idx], neg).contiguous()
        p2 = torch.where(live, pos[idx], neg).contiguous()
        out = ops.ragged_paged_attention(q2.contiguous(), kp, vp, bt, r2, p2,
                                         **kw)
        assert torch.equal(out[live], base[idx[live]]), \
            f"{name}: a lane's output depends on its packing"
        assert bool((out[~live] == 0).all()), f"{name}: pad lanes not zero"
        segments[name] = len(ref.ragged_segment_plan(
            bt.cpu(), r2.cpu(), p2.cpu(), G=q.shape[1] // kp.shape[2],
            bs=kp.shape[1], window=kw["window"]))
    segments["original"] = len(ref.ragged_segment_plan(
        bt.cpu(), rows.cpu(), pos.cpu(), G=q.shape[1] // kp.shape[2],
        bs=kp.shape[1], window=kw["window"]))
    return segments


def k1_build_report() -> dict:
    """What the compiler made of K1's tensor-core kernel: ``ptxas -v``'s
    registers, static shared memory and spills for each instantiation
    (pool type, largest head_dim), and its mma.sync (HMMA) count in SASS."""
    import re

    from repro_torch.kernels import build

    kinds = {"13__nv_bfloat16": "bf16", "a": "int8", "13__nv_fp8_e4m3": "fp8"}

    def label(mangled: str) -> str:
        m = re.search(r"ragged_tc_kernelI(\w+?)Lb[01]ELi(\d+)E", mangled)
        if m is None:
            return mangled
        return f"tc::ragged_tc_kernel<{kinds.get(m.group(1), m.group(1))}, " \
               f"{m.group(2)}>"

    hmma = build.sass_count("ragged_paged_attention", "HMMA")
    return {"phase": "k1_build",
            "ptxas": [dict(r, kernel=label(r["kernel"]))
                      for r in build.ptxas_report("ragged_paged_attention")
                      if "ragged_tc" in r["kernel"]],
            "hmma": ({label(k): n for k, n in hmma.items() if "ragged_tc" in k}
                     if hmma is not None else "not measured")}


def kernel_phase(dev) -> list[dict]:
    from repro_torch.kernels.decode_attention import ops, quant, ref

    rng = np.random.default_rng(0)
    q32, k32, v32, bt, rows, pos, n_valid, bt_np, rows_np, pos_np = \
        kernel_inputs(dev, rng)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    emit(k1_build_report())
    emit({"phase": "kernel_bound", "bound_ms": BOUND_FORMULA,
          "library_ms": LIBRARY_NOTE})
    cases = []
    for kv_dtype in ("float32", "bfloat16", "int8", "fp8_e4m3"):
        # f32 pool with f32 q: the JAX suite's 2e-5.  Otherwise q is the
        # served model's bf16 and the output is rounded to bf16 on both
        # sides (one bf16 ulp of |out| <= 1 is 2^-8): the suite's 2e-2.
        if kv_dtype == "float32":
            q, kp, vp, ks, vs, tol = q32, k32, v32, None, None, 2e-5
        else:
            q, tol = q32.to(torch.bfloat16), 2e-2
            if kv_dtype == "bfloat16":
                kp, vp, ks, vs = k32.to(torch.bfloat16), v32.to(
                    torch.bfloat16), None, None
            else:
                kp, ks = quant.quantize_kv(k32, kv_dtype)
                vp, vs = quant.quantize_kv(v32, kv_dtype)
        kv_item = kp.element_size()
        for window in (None, 4096):
            for cap in (None, 50.0):
                args = (q, kp, vp, bt, rows, pos)
                kw = dict(k_scale=ks, v_scale=vs, window=window, softcap=cap)
                if ks is None:
                    plain = lambda q=q: ref.ragged_paged_attention_ref(
                        q, kp, vp, bt, rows, pos, window=window, softcap=cap)
                else:
                    plain = lambda q=q: ref.ragged_paged_attention_quant_ref(
                        q, kp, vp, ks, vs, bt, rows, pos, window=window,
                        softcap=cap)
                case, out = checked_case(
                    lambda: ops.ragged_paged_attention(*args, **kw), plain,
                    tol, *work(bt_np, rows_np, pos_np, window, kv_item,
                               q.element_size(), ks is not None),
                    q.dtype, flush, (25, 5),
                    plain32=(None if kv_dtype == "float32"
                             else lambda: plain(q.float())),
                    kv_dtype=kv_dtype,
                    q_dtype=str(q.dtype).split(".")[1], window=window,
                    softcap=cap, library_ms=None,
                    **k1_spans(T, KV, H // KV, D, bt.shape[1]),
                    **k1_route(q, kp, bt, rows, pos, window))
                assert bool((out[n_valid:] == 0).all()), "pad lanes not zero"
                cases.append(case)
                emit({"phase": "kernel", **case})
        # bit-exact contracts, once per pool dtype
        kw = dict(k_scale=ks, v_scale=vs, window=4096, softcap=50.0)
        tight = ops.ragged_paged_attention(q, kp, vp, bt, rows, pos, **kw)
        wide = torch.cat([bt, torch.full((bt.shape[0], 7), -1,
                                         dtype=torch.int32, device=dev)], 1)
        widened = ops.ragged_paged_attention(q, kp, vp, wide.contiguous(),
                                             rows, pos, **kw)
        assert torch.equal(tight, widened), "-1 widening changed the output"
        dec = [0, 1, 2, 3, 4]                       # the decode rows
        dpos = pos[:5].contiguous()
        decode = ops.paged_decode_attention(q[:5].contiguous(), kp, vp,
                                            bt[dec].contiguous(), dpos, **kw)
        lanes = [6, 1, 3, 9, 4]                     # scrambled, pads between
        qr = torch.zeros((10, H, D), dtype=q.dtype, device=dev)
        rr = torch.full((10,), -1, dtype=torch.int32, device=dev)
        pr = torch.full((10,), -1, dtype=torch.int32, device=dev)
        for b, lane in enumerate(lanes):
            qr[lane], rr[lane], pr[lane] = q[b], b, dpos[b]
        packed = ops.ragged_paged_attention(qr, kp, vp, bt[dec].contiguous(),
                                            rr, pr, **kw)
        for b, lane in enumerate(lanes):
            assert torch.equal(packed[lane], decode[b]), "k=0 row != decode"
        assert bool((packed[[0, 2, 5, 7, 8]] == 0).all())
        segments = repack_contract(q, kp, vp, bt, rows, pos, n_valid,
                                   rows_np, kw)
        emit({"phase": "kernel_contracts", "kv_dtype": kv_dtype,
              "route": ops.ragged_paged_attention_route(q, kp),
              "pad_lanes_zero": True, "widening_bit_invariant": True,
              "k0_verify_equals_decode": True,
              "repacking_bit_invariant": True, "segments": segments})
    for arch, h, kv, d, window in K1_WIDTHS:
        q, kp, vp, bt, rows, pos, n_valid, bt_np, rows_np, pos_np = \
            kernel_inputs(dev, np.random.default_rng(3), h, kv, d)
        args = tuple(x.to(torch.bfloat16) for x in (q, kp, vp)) + (bt, rows,
                                                                    pos)
        case, out = checked_case(
            lambda: ops.ragged_paged_attention(*args, window=window),
            lambda: ref.ragged_paged_attention_ref(*args, window=window),
            2e-2, *work(bt_np, rows_np, pos_np, window, 2, 2, False, h, kv, d),
            torch.bfloat16, flush, (25, 5),
            plain32=lambda: ref.ragged_paged_attention_ref(
                args[0].float(), *args[1:], window=window),
            kv_dtype="bfloat16",
            q_dtype="bfloat16", arch=arch, H=h, K=kv, D=d, window=window,
            softcap=None, library_ms=None,
            **k1_spans(T, kv, h // kv, d, bt.shape[1]),
            **k1_route(args[0], args[1], bt, rows, pos, window))
        assert bool((out[n_valid:] == 0).all()), "pad lanes not zero"
        cases.append(case)
        emit({"phase": "kernel", **case})
    cases += decode_tick_cases(dev, flush)
    return cases


def decode_tick_cases(dev, flush) -> list[dict]:
    """K1 at the serve phase's decode tick (``DECODE_TICK_ROWS``: 8 decode
    rows padded to 512 lanes, gemma2-9b's widths, window 4096, softcap 50),
    bf16 and int8 pools, against the plain version."""
    from repro_torch.kernels.decode_attention import ops, quant, ref

    q32, k32, v32, bt, rows, pos, n_valid, bt_np, rows_np, pos_np = \
        kernel_inputs(dev, np.random.default_rng(4), reqs=DECODE_TICK_ROWS)
    q = q32.to(torch.bfloat16)
    out_cases = []
    for kv_dtype in ("bfloat16", "int8"):
        if kv_dtype == "bfloat16":
            kp, vp, ks, vs = k32.to(torch.bfloat16), v32.to(torch.bfloat16), \
                None, None
        else:
            kp, ks = quant.quantize_kv(k32, kv_dtype)
            vp, vs = quant.quantize_kv(v32, kv_dtype)
        kw = dict(k_scale=ks, v_scale=vs, window=4096, softcap=50.0)
        if ks is None:
            plain = lambda q=q: ref.ragged_paged_attention_ref(
                q, kp, vp, bt, rows, pos, window=4096, softcap=50.0)
        else:
            plain = lambda q=q: ref.ragged_paged_attention_quant_ref(
                q, kp, vp, ks, vs, bt, rows, pos, window=4096, softcap=50.0)
        case, out = checked_case(
            lambda: ops.ragged_paged_attention(q, kp, vp, bt, rows, pos, **kw),
            plain, 2e-2, *work(bt_np, rows_np, pos_np, 4096,
                               kp.element_size(), 2, ks is not None),
            torch.bfloat16, flush, (25, 5),
            plain32=lambda: plain(q.float()), kv_dtype=kv_dtype,
            q_dtype="bfloat16", tick="decode", rows=len(DECODE_TICK_ROWS),
            window=4096, softcap=50.0, library_ms=None,
            **k1_spans(T, KV, H // KV, D, bt.shape[1]),
            **k1_route(q, kp, bt, rows, pos, 4096))
        assert bool((out[n_valid:] == 0).all()), "pad lanes not zero"
        out_cases.append(case)
        emit({"phase": "kernel", **case})
    return out_cases


# ================================================================== model
def model_phase(cfg, dev) -> dict:
    """One packed step of the full-width model cut to 2 layers: the kernel
    path against the same step with the plain attention on the same pool."""
    from repro_torch.kernels.decode_attention import ref
    from repro_torch.models import (attention, init_paged_pools, init_params,
                                    paged_mixed_step)

    small = cfg.replace(n_layers=2)
    params = init_params(small, torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    params["embed"]["table"].mul_(small.d_model ** -0.5)
    rng = np.random.default_rng(1)
    Tm = 64
    bt = torch.tensor([[1, 2, 3, 4, -1, -1, -1, -1],
                       [5, 6, -1, -1, -1, -1, -1, -1]], dtype=torch.int32,
                      device=dev)
    toks = torch.from_numpy(rng.integers(0, small.vocab_size, Tm).astype(
        np.int32)).to(dev)
    pos = torch.tensor(list(range(50)) + list(range(10)) + [-1] * 4,
                       dtype=torch.int32, device=dev)
    rows = torch.tensor([0] * 50 + [1] * 10 + [-1] * 4, dtype=torch.int32,
                        device=dev)
    sidx = torch.tensor([49, 59], dtype=torch.int32, device=dev)
    logits = {}
    kernel_fn = attention.da_ops.ragged_paged_attention

    def plain_fn(*a, k_scale=None, v_scale=None, **kw):
        return ref.ragged_paged_attention_ref(*a, **kw)

    for name, fn in (("kernel", kernel_fn), ("plain", plain_fn)):
        attention.da_ops.ragged_paged_attention = fn
        try:
            pools = init_paged_pools(small, 16, 16, device=dev)
            logits[name] = paged_mixed_step(params, pools, bt, toks, pos,
                                            rows, sidx, small)
        finally:
            attention.da_ops.ragged_paged_attention = kernel_fn
    a, b = logits["kernel"], logits["plain"]
    assert a.shape == (2, small.vocab_size) and bool(torch.isfinite(a).all())
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    # bf16 activations: the attention outputs may differ by one bf16 ulp,
    # which two layers carry into the logits at the 1e-2 relative level
    assert err <= 2e-2 * scale, (err, scale)
    res = {"phase": "model", "layers": 2, "max_abs_err": err,
           "logit_scale": scale, "argmax_equal":
           bool(torch.equal(a.argmax(-1), b.argmax(-1)))}
    emit(res)
    del params
    return res


# ================================================================== serve
def serve_requests(vocab: int):
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(2)
    prefix = rng.integers(0, vocab, 64)
    phrase = rng.integers(0, vocab, 20)
    prompts = [rng.integers(0, vocab, 4500),
               np.concatenate([prefix, rng.integers(0, vocab, 100)]),
               np.concatenate([prefix, rng.integers(0, vocab, 236)]),
               np.tile(phrase, 6),          # repetitive: n-gram drafts fire
               rng.integers(0, vocab, 16),
               rng.integers(0, vocab, 77),
               rng.integers(0, vocab, 300),
               rng.integers(0, vocab, 31)]
    return [Request(request_id=f"r{i}", session_key=f"s{i}",
                    prompt=p.astype(np.int32), max_new_tokens=32)
            for i, p in enumerate(prompts)]


@contextlib.contextmanager
def syncs_forbidden(*engines):
    """Inside the block every synchronizing CUDA call raises
    (``torch.cuda.set_sync_debug_mode("error")``, process-wide: a serving
    node's upcall threads too), except in each engine's one pull per
    dispatch, ``_to_host`` (which a spill's pull goes through as well)."""
    def exempt(inner):
        def to_host(*a):
            torch.cuda.set_sync_debug_mode(0)
            try:
                return inner(*a)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return to_host

    for eng in engines:
        eng._to_host = exempt(eng._to_host)
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
        for eng in engines:
            del eng._to_host


def check_graphs(eng, kernel_ticks: int) -> dict:
    """A captured engine captured its tick once and replayed it at every
    tick after the first (eager) one; an eager engine captured nothing."""
    s = eng.stats
    if eng.cuda_graphs:
        assert s.graph_captures == 1, s.graph_captures
        assert s.graph_replays == kernel_ticks - 1, (s.graph_replays,
                                                     kernel_ticks)
    else:
        assert s.graph_captures == s.graph_replays == 0, s
    return {"cuda_graphs": eng.cuda_graphs, "graph_captures":
            s.graph_captures, "graph_replays": s.graph_replays,
            "graph_capture_s": s.graph_capture_s}


def allocated_outside_workspaces() -> int:
    """Device bytes allocated, less the kernels' shared workspaces (which
    outlive every engine)."""
    from repro_torch import kernels

    return torch.cuda.memory_allocated() - sum(
        b.numel() * b.element_size() for b in kernels._workspaces.values())


def graph_ref(eng):
    """A weak reference to the engine's captured graph (None if eager)."""
    graph = eng._tick_runner.graph
    return None if graph is None else weakref.ref(graph)


def check_dropped(ref, before: int) -> int:
    """After the caller deleted its engine: its graph went with it.  Returns
    the bytes still allocated (outside the workspaces) beyond ``before``,
    taken before the engine was built."""
    torch.cuda.empty_cache()
    assert ref is None or ref() is None, "the engine's CUDA graph outlived it"
    return allocated_outside_workspaces() - before


def serve_once(cfg, params, dev, smi: str, reqs=None, **kw
               ) -> tuple[dict, dict]:
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.serving.engine import ServeEngine

    base = allocated_outside_workspaces()
    eng = ServeEngine(cfg, params, n_slots=8, token_budget=512, max_len=8192,
                      num_blocks=1024, device=dev, **kw)
    assert eng.cm.pools[0]["k"].device.type == dev.type
    assert params["embed"]["table"].device.type == dev.type
    done = []
    eng.on_complete = done.append
    reqs = serve_requests(cfg.vocab_size) if reqs is None else reqs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.ragged_paged_attention.launches = 0
    t0 = time.monotonic()
    with syncs_forbidden(eng):
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.ragged_paged_attention.launches
    s = eng.stats
    assert len(done) == len(reqs) and all(r.error is None for r in done)
    assert all(len(r.tokens) == r.max_new_tokens for r in done)
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.tokens)
    assert all(np.isfinite(r.scores).all() for r in done)
    assert s.host_syncs == s.ticks, (s.host_syncs, s.ticks)
    assert s.prefix_hit_tokens > 0
    res = {"phase": "serve", "arch": cfg.name,
           "kv_dtype": kw.get("kv_dtype") or "bfloat16",
           "spec_k": kw.get("spec_k", 0),
           "temperature": kw.get("temperature", 0.0), "card": smi,
           "n_layers": cfg.n_layers, "pool_bytes": eng.cm.pool_bytes(),
           "num_blocks": eng.cm.num_blocks, "ticks": s.ticks,
           **check_graphs(eng, s.ticks),
           "host_syncs": s.host_syncs, "k1_launches": launches,
           "prefill_chunks": s.prefill_chunks,
           "prefix_hit_tokens": s.prefix_hit_tokens,
           "spec_drafted": s.spec_drafted, "spec_accepted": s.spec_accepted,
           "tokens_out": s.tokens_out, "wall_s": wall,
           "tokens_per_s": s.tokens_out / wall,
           "ttft_p50_s": statistics.median(s.ttft_s),
           "tpot_p50_s": statistics.median(s.tpot_s),
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    streams = {r.request_id: list(r.tokens) for r in done}
    ref = graph_ref(eng)
    del eng
    res["kept_after_delete_bytes"] = check_dropped(ref, base)
    emit(res)
    return res, streams


GRAPH_METRICS = ("ttft_p50_s", "tpot_p50_s", "tokens_per_s",
                 "peak_mem_bytes", "device_idle_share", "graph_capture_s")


def graphs_line(path: str, smi: str, first: dict, captured: dict,
                eager: dict) -> dict:
    """Captured against eager on one path, measured in this call.  The runs
    went captured (``first``: the process's first serve of the model, which
    also pays the allocator's and the libraries' first calls), eager,
    captured again; ``captured`` is the second captured run, which like the
    eager one follows a serve of the same model."""
    res = {"phase": "graphs", "path": path, "card": smi,
           "captured": {m: captured[m] for m in GRAPH_METRICS},
           "eager": {m: eager[m] for m in GRAPH_METRICS},
           "captured_first_run": {m: first[m] for m in GRAPH_METRICS
                                  if m in first}}
    emit(res)
    return res


def serve_phase(dev, smi: str) -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_params

    cfg = get_config("gemma2-9b")
    model_phase(cfg, dev)
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    # N(0, 1/d) embedding rows (x sqrt(d) at lookup gives unit-scale
    # inputs, as a trained gemma has) instead of the initialiser's N(0, 1),
    # whose logits saturate the final softcap and make every stream a tie
    params["embed"]["table"].mul_(cfg.d_model ** -0.5)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    assert n_params == cfg.param_count(), (n_params, cfg.param_count())
    emit({"phase": "init", "params": n_params,
          "seconds": time.monotonic() - t0})
    main, greedy = serve_once(cfg, params, dev, smi)
    assert main["pool_bytes"] >= 4 << 30
    eager, eager_streams = serve_once(cfg, params, dev, smi,
                                      cuda_graphs=False)
    assert eager_streams == greedy, "captured and eager streams differ"
    again, again_streams = serve_once(cfg, params, dev, smi)
    assert again_streams == greedy, "a second captured run differs"
    spec, spec_streams = serve_once(cfg, params, dev, smi, spec_k=2)
    assert spec_streams == greedy, "spec_k=2 greedy streams differ"
    assert spec["spec_drafted"] > 0
    int8, int8_streams = serve_once(cfg, params, dev, smi, kv_dtype="int8")
    int8_eager, int8_eager_streams = serve_once(
        cfg, params, dev, smi, kv_dtype="int8", cuda_graphs=False)
    assert int8_eager_streams == int8_streams, "int8: captured != eager"
    for res in (main, eager, again, spec, int8, int8_eager):
        # K1 at every layer of every tick
        assert res["k1_launches"] == res["ticks"] * cfg.n_layers, res
    # sampled: the engine's generator, reseeded per dispatch, draws the
    # same numbers in a replayed graph as in the eager tick
    sampled = {graphs: serve_once(cfg, params, dev, smi,
                                  reqs=serve_requests(cfg.vocab_size)[1:4],
                                  spec_k=2, temperature=1.0,
                                  cuda_graphs=graphs)[1]
               for graphs in (True, False)}
    assert sampled[True] == sampled[False], "sampled: captured != eager"
    traced = {graphs: trace_phase(cfg, params, dev, graphs)
              for graphs in (True, False)}
    graphs_line("paged gemma2-9b bf16 spec_k=0", smi, main,
                dict(again, **traced[True]), dict(eager, **traced[False]))
    main["streams"] = greedy
    return main


def device_kernels(prof) -> dict:
    """Device records of a profiled run by name: (count, total µs).  Read
    from the raw Kineto events, as ``key_averages()`` sums them for device
    records, without building its host-side event tree (tens of seconds
    for a traced serve run)."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            n, us = out.get(ev.name(), (0, 0.0))
            out[ev.name()] = (n + 1, us + ev.duration_ns() / 1e3)
    return out


def kernel_launches(prof, names) -> int:
    """Launches of the device kernels whose names hold one of ``names``, as
    the profiler recorded them."""
    return sum(n for key, (n, _) in device_kernels(prof).items()
               if any(p in key for p in names))


# the profiler loses device records now and then, more often as the
# process ages: 10 and 70 of a traced serve run's 1,764 K1 combines in two
# runs of this script, a few records at a session's start, once a block of
# thousands inside a run (``trace_records.py`` counts them session by
# session).  The wrappers' own counts are held exactly; the trace's to at
# most the launches and at least this share short of them, and a run that
# fell shorter is run again
TRACE_DROP_SHARE = 0.01
TRACE_ATTEMPTS = 3


def retraced(trace_once) -> dict:
    """Run ``trace_once`` (one profiled run: returns its result, and the
    wrappers' launches and the trace's records per kernel) until every
    kernel's records fall at most ``TRACE_DROP_SHARE`` short of its
    launches, at most ``TRACE_ATTEMPTS`` times; each run's result is
    emitted with its ``records_dropped`` and ``attempt``.  A record more
    than the launches fails at once: a launch the wrapper did not count."""
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        res, launched, traced = trace_once()
        dropped = {k: n - traced[k] for k, n in launched.items()}
        assert min(dropped.values()) >= 0, (launched, traced)
        res.update(records_dropped=dropped, attempt=attempt)
        emit(res)
        if all(d <= TRACE_DROP_SHARE * launched[k]
               for k, d in dropped.items()):
            return res
    raise AssertionError(
        f"the trace fell more than {TRACE_DROP_SHARE:.0%} short of the "
        f"launches in {TRACE_ATTEMPTS} runs: {launched}, {traced}")


def trace_phase(cfg, params, dev, cuda_graphs: bool, groups=None) -> dict:
    """Where the time goes: the main serve run again under torch.profiler,
    device time by kernel (self time, summed over launches, in ``groups``:
    K1 and the dense products unless given) and the device's busy share of
    the wall time.  K1's launches by its wrapper's count (== ticks x
    layers, exactly) and as the trace counts them (one combine kernel per
    call; at most 1 % of the records dropped, ``records_dropped``, else
    the run again: ``retraced``).  The timings above come from runs
    without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attention import ops
    from repro_torch.serving.engine import ServeEngine

    def trace_once():
        base = allocated_outside_workspaces()
        eng = ServeEngine(cfg, params, n_slots=8, token_budget=512,
                          max_len=8192, num_blocks=1024, device=dev,
                          cuda_graphs=cuda_graphs)
        for r in serve_requests(cfg.vocab_size):
            eng.submit(r)
        ops.ragged_paged_attention.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            eng.run_until_drained()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        ticks = eng.stats.ticks
        launches = ops.ragged_paged_attention.launches
        assert launches == ticks * cfg.n_layers, (launches, ticks)
        traced = kernel_launches(prof, ("ragged_combine_kernel",))
        res = {"phase": "trace", "cuda_graphs": cuda_graphs, "ticks": ticks,
               "k1_launches": launches, "k1_launches_traced": traced,
               **_device_time(prof, wall, groups or {"K1": K1_KERNELS,
                                                     "gemm": GEMM_KEYS})}
        ref = graph_ref(eng)
        del eng, prof
        check_dropped(ref, base)
        return res, {"K1": launches}, {"K1": traced}

    return retraced(trace_once)


# ============================================================ flash kernel
# (arch, B, S, H, K, D, dtype, window, softcap): gemma2-9b's attention at
# S = 8192 in both dtypes with and without its window and softcap, one case
# at each other config's shapes and window (zamba2-2.7b's shared attention:
# D = 160, MHA; the MoE configs' D = 128, G = 1 and 5), a ragged S, the
# shapes zamba2-2.7b's dense prefill sends in serve_dense (4 x 2048
# batched, and 17 and 300 tokens), and the embeds configs' MHA at D = 64
# (musicgen-large) and D = 96 (phi-3-vision-4.2b): their score forward's
# S = 8192 and the (B, S) shapes the embeds paths send (serve_embeds' and
# the node's prefills: 4 x 2048, 4500, 1000, 300, 17; embeds_check's
# prefill, 8 x 1000, and its forward, 8 x 1032), ragged tails included
EMBEDS_FLASH_SHAPES = ((4, 2048), (1, 4500), (1, 1000), (1, 300), (1, 17),
                       (8, 1000), (8, 1032))
FLASH_CASES = (
    [("gemma2-9b", 1, 8192, 16, 8, 256, dt, w, c)
     for dt in (torch.float32, torch.bfloat16)
     for w in (None, 4096) for c in (None, 50.0)]
    + [("gemma3-4b", 1, 8192, 8, 4, 256, torch.bfloat16, 1024, None),
       ("h2o-danube-1.8b", 1, 8192, 32, 8, 80, torch.bfloat16, 4096, None),
       ("h2o-danube-3-4b", 1, 9216, 32, 8, 120, torch.bfloat16, 8192, None),
       ("zamba2-2.7b", 1, 8192, 32, 32, 160, torch.bfloat16, None, None),
       ("deepseek-moe-16b", 1, 8192, 16, 16, 128, torch.bfloat16, None,
        None),
       ("llama4-maverick-400b-a17b", 1, 8192, 40, 8, 128, torch.bfloat16,
        None, None),
       ("gemma2-9b", 1, 8000, 16, 8, 256, torch.bfloat16, 4096, 50.0)]
    + [("zamba2-2.7b", B, S, 32, 32, 160, torch.bfloat16, None, None)
       for B, S in ((4, 2048), (1, 17), (1, 300))]
    + [(arch, B, S, 32, 32, D_, torch.bfloat16, None, None)
       for arch, D_ in (("musicgen-large", 64), ("phi-3-vision-4.2b", 96))
       for B, S in ((1, 8192), *EMBEDS_FLASH_SHAPES)])
FLASH_BOUND = (
    "max(bytes / 3.35e12 B/s, flops / peak[dtype]); bytes = (q + out) "
    "B*S*H*D + (k + v) B*S*K*D, times the itemsize; flops = 4*D*H per "
    "visible (query, key) pair, B * sum_i min(i + 1, window); peak 989e12 "
    "(bf16 tensor cores) or 67e12 (f32)")
FLASH_LIBRARY = (
    "one PyTorch call computing the same function, its inputs and masks "
    "built outside the timed region; the port calls none of them: "
    "scaled_dot_product_attention with K and V expanded to H heads, "
    "is_causal=True without a window, an additive band mask (j <= i, "
    "i - j < window) with one; flex_attention (torch.compile'd) where there "
    "is a softcap, the tanh softcap as score_mod and the causal band and "
    "window as a block mask, GQA native")
K2_TPU = "src/repro/kernels/flash_attention/kernel.py:89"
K2_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"


def visible_pairs(S: int, window: int | None) -> int:
    from repro_torch.kernels.flash_attention.ops import visible_pairs

    return visible_pairs(S, window)


def flash_work(B, S, H, K, D, window, item):
    """K2's own count (``ops.work``), which its meta route also reads."""
    from repro_torch.kernels.flash_attention.ops import work

    return work(B, S, H, K, D, window, item)


@functools.cache
def _compiled_flex():
    import torch._dynamo
    from torch.nn.attention.flex_attention import flex_attention

    # one compile per case's shapes (K2's and K4's), more than dynamo's
    # default limit of recompiles per function
    for name in ("recompile_limit", "cache_size_limit"):
        if hasattr(torch._dynamo.config, name):
            setattr(torch._dynamo.config, name, 64)
    return torch.compile(flex_attention, dynamic=False, fullgraph=True)


def library_call(q, k, v, window, cap):
    """K2's function on these inputs as one PyTorch call, in (B, H, S, D)
    layout, and the call's name (see ``FLASH_LIBRARY``).  Everything but
    the call itself is built here."""
    import torch.nn.functional as F

    S, H_, K_ = q.shape[1], q.shape[2], k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    if cap is None:
        kt, vt = (x.repeat_interleave(H_ // K_, dim=2).transpose(
            1, 2).contiguous() for x in (k, v))
        if window is None:
            return (lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)), "sdpa_causal"
        i = torch.arange(S, device=q.device)
        band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        bias = torch.zeros((S, S), dtype=q.dtype, device=q.device)
        bias.masked_fill_(~band, float("-inf"))
        del band
        return (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias)), "sdpa_band_mask"
    from torch.nn.attention.flex_attention import create_block_mask

    kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))

    def visible(b, h, qi, kj):
        m = kj <= qi
        return m if window is None else m & (qi - kj < window)

    def softcap(s, b, h, qi, kj):
        return cap * torch.tanh(s / cap)

    mask = create_block_mask(visible, None, None, S, S, device=q.device)
    flex = _compiled_flex()
    return (lambda: flex(qt, kt, vt, score_mod=softcap, block_mask=mask,
                         enable_gqa=True)), "flex_attention"


def _kernel_label(mangled: str) -> str:
    """``tc::flash_attention_wgmma<4, 256>`` for a mangled K2 kernel name."""
    import re

    m = re.search(r"(simt|tc)\d+(flash_attention_[a-z]+)I((?:Li\d+E)+)",
                  mangled)
    if m is None:
        return mangled
    args = ", ".join(re.findall(r"Li(\d+)E", m.group(3)))
    return f"{m.group(1)}::{m.group(2)}<{args}>"


def flash_build_report() -> dict:
    """What the compiler made of K2: ``ptxas -v``'s registers, static
    shared memory and spills for each instantiation (tc<NC, PN>: the bf16
    tensor-core kernel at padded head_dim 64·NC and P·V width PN;
    simt<NJ>: the f32 kernel),
    and the count of HGMMA (wgmma) instructions in each kernel's SASS."""
    from repro_torch.kernels import build

    hgmma = build.sass_count("flash_attention", "HGMMA")
    return {"phase": "flash_build",
            "ptxas": [dict(r, kernel=_kernel_label(r["kernel"]))
                      for r in build.ptxas_report("flash_attention")],
            "hgmma": ({_kernel_label(k): n for k, n in hgmma.items()}
                      if hgmma is not None else "not measured")}


def flash_kernel_phase(dev, cases=FLASH_CASES, reps=(10, 3)) -> list[dict]:
    """K2 against its plain version on the card at each case's shapes."""
    from repro_torch.kernels.flash_attention import ops, ref

    emit(flash_build_report())
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    emit({"phase": "flash_bound", "bound_ms": FLASH_BOUND,
          "library_ms": FLASH_LIBRARY})
    out_cases = []
    for i, (arch, B, S, H_, K_, D_, dt, window, cap) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(100 + i)
        q, k, v = (torch.randn((B, S, n, D_), generator=g, device=dev).to(dt)
                   for n in (H_, K_, K_))
        kw = dict(window=window, softcap=cap)
        # the JAX suite's tolerances (tests/test_kernels.py:43), and in bf16
        # each element held to its one rounding from the f32 value
        case, out = checked_case(
            lambda: ops.flash_attention(q, k, v, **kw),
            lambda: ref.attention_ref(q, k, v, **kw),
            2e-5 if dt == torch.float32 else 2e-2,
            *flash_work(B, S, H_, K_, D_, window, q.element_size()), dt,
            flush, reps,
            plain32=(None if dt == torch.float32 else lambda: ref.attention_ref(
                q.float(), k.float(), v.float(), **kw)),
            arch=arch, B=B, S=S, H=H_, K=K_, D=D_,
            dtype=str(dt).split(".")[1], window=window, softcap=cap)
        assert out.dtype == dt and out.shape == q.shape
        lib, lib_name = library_call(q, k, v, window, cap)
        lib_err = (lib().transpose(1, 2).float()
                   - out.float()).abs().max().item()
        case.update(library=lib_name, library_ms=cuda_ms(lib, reps[0], flush),
                    library_vs_kernel_max_abs_err=lib_err,
                    plan=ops.launch_plan(D_, dt)._asdict())
        del lib
        out_cases.append(case)
        emit({"phase": "flash_kernel", **case})
        del q, k, v, out
    del flush
    torch.cuda.empty_cache()
    return out_cases


# ============================================================= ssd kernel
K3_TPU = "src/repro/kernels/ssd/kernel.py:80"
K3_SRC = "src/repro_torch/kernels/csrc/ssd.cu"
# (arch, B, S, H, P, N, chunk): mamba2-1.3b's layer on the serve phase's
# 4500-token prompt (S % 256 != 0) and its batched 4 x 2048 prefill, a
# 17-token prompt (Q = 17), zamba2-2.7b's mamba layer, and mamba2-1.3b's
# layer in the score phase's forward (S = 8192: 32 chunks)
SSD_SHAPES = [("mamba2-1.3b", 1, 4500, 64, 64, 128, 256),
              ("mamba2-1.3b", 4, 2048, 64, 64, 128, 256),
              ("mamba2-1.3b", 1, 17, 64, 64, 128, 256),
              ("zamba2-2.7b", 1, 4500, 80, 64, 64, 256),
              ("mamba2-1.3b", 1, 8192, 64, 64, 128, 256)]
SSD_TOL = (5e-4, 1e-3)    # atol, rtol: the JAX suite's (tests/test_kernels.py)
SSD_BOUND = (
    "max(bytes / 3.35e12 B/s, flops / peak[x dtype]); bytes = x "
    "B*S*H*P*itemsize + y B*S*H*P*4 + B and C 2*B*S*N*itemsize + dt B*S*H*4 + "
    "A (and D) H*4 + h_final (and h0) B*H*P*N*4; flops, per batch row and "
    "chunk of L steps: C.B^T once for all heads on the causal pairs, "
    "2*N*L(L+1)/2, and per head 2*P*L(L+1)/2 (scores x x) + 4*L*P*N (the "
    "inter-chunk term and the state carry); peak 989e12 (bf16 tensor cores) "
    "or 67e12 (f32)")
SSD_LIBRARY = "none: no single PyTorch call computes the SSD chunked scan"


def ssd_work(B, S, H, P, N, Q, item, h0, D):
    """K3's own count (``ops.work``), which its meta route also reads."""
    from repro_torch.kernels.ssd.ops import work

    return work(B, S, H, P, N, Q, item, h0, D)


def _ssd_label(name: str) -> str:
    """``ssd_scan_kernel`` for a mangled or demangled K3 kernel name."""
    import re

    m = re.search(r"(ssd_[a-z_]+_kernel)", name)
    return m.group(1) if m else name


def ssd_build_report() -> dict:
    """What the compiler made of K3: ``ptxas -v``'s registers, shared
    memory, stack and spills of each stage kernel (and the f32 FMA kernel),
    and the count of HMMA (mma.sync) instructions in each kernel's SASS."""
    from repro_torch.kernels import build

    hmma = build.sass_count("ssd", "HMMA")
    rep = {"phase": "ssd_build",
           "ptxas": [dict(r, kernel=_ssd_label(r["kernel"]))
                     for r in build.ptxas_report("ssd")],
           "hmma": ({_ssd_label(k): n for k, n in hmma.items()}
                    if hmma is not None else "not measured")}
    if hmma is not None:
        assert rep["hmma"].get("ssd_scan_kernel", 0) > 0, rep["hmma"]
    return rep


def ssd_stage_split(fn, want=()) -> dict:
    """Device time (ms) of each K3 kernel in one profiled call of ``fn``,
    profiled again, at most ``TRACE_ATTEMPTS`` times in all, while a
    kernel of ``want`` has no record (``torch.profiler`` loses device
    records now and then, W6)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {_ssd_label(key): us / 1e3
               for key, (_, us) in device_kernels(prof).items()
               if us > 0 and "ssd_" in key}
        if all(k in out for k in want):
            break
    return out


def ssd_kernel_phase(dev, shapes=SSD_SHAPES, reps=(10, 3),
                     dtypes=(torch.bfloat16, torch.float32)) -> list[dict]:
    """K3 against its plain version on the card: every shape in each of
    ``dtypes``, with and without h0, with and without the D-term.  y and h_final
    (f32 in both versions) are held element by element to the JAX suite's
    SSD tolerance, |out - plain| <= 5e-4 + 1e-3 |plain| (ratio
    ``err_over_tol`` <= 1), which is tighter than one bf16 rounding.  Each
    case also names its route (bf16 must take the tensor cores) and its
    workspace bytes, and two calls must give the same bits; the first case
    of each shape and dtype reports the device time of each stage kernel
    from one profiled call."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd import ops, ref

    emit(ssd_build_report())
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    emit({"phase": "ssd_bound", "bound_ms": SSD_BOUND,
          "library_ms": SSD_LIBRARY})
    atol, rtol = SSD_TOL
    cases = []
    for i, (arch, B, S, H, P, N, chunk) in enumerate(shapes):
        g = torch.Generator(device=dev).manual_seed(200 + i)
        rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
        x32, B32, C32 = rnd(B, S, H, P), rnd(B, S, N) / N ** 0.5, \
            rnd(B, S, N) / N ** 0.5
        dt = F.softplus(rnd(B, S, H))
        A = -torch.exp(rnd(H) * 0.5)
        D_ = rnd(H)
        h0_ = rnd(B, H, P, N) * 0.5
        for dtype in dtypes:
            x, Bm, Cm = (a.to(dtype) for a in (x32, B32, C32))
            for with_h0 in (True, False):
                for with_d in (False, True):
                    h0 = h0_ if with_h0 else None
                    D = D_ if with_d else None
                    kernel = lambda: ops.ssd(x, dt, A, Bm, Cm, D, chunk=chunk,
                                             h0=h0)
                    plain = lambda: ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D,
                                                        chunk=chunk, h0=h0)
                    (y, h), (yp, hp) = kernel(), plain()
                    y2, h2 = kernel()
                    torch.cuda.synchronize()
                    assert y.dtype == h.dtype == torch.float32
                    assert y.shape == x.shape and h.shape == (B, H, P, N)
                    err = max((y - yp).abs().max().item(),
                              (h - hp).abs().max().item())
                    over = max(((y - yp).abs() / (atol + rtol * yp.abs()))
                               .max().item(),
                               ((h - hp).abs() / (atol + rtol * hp.abs()))
                               .max().item())
                    case = {"arch": arch, "B": B, "S": S, "H": H, "P": P,
                            "N": N, "chunk": chunk, "Q": min(chunk, S),
                            "dtype": str(dtype).split(".")[1],
                            "h0": with_h0, "D": with_d,
                            "route": ops.ssd_route(x),
                            "workspace_bytes": ops.workspace_bytes(x, Bm,
                                                                   chunk),
                            "max_abs_err": err, "err_over_tol": over,
                            "y_scale": yp.abs().max().item(),
                            "bit_equal_repeat": bool(torch.equal(y, y2)
                                                     and torch.equal(h, h2))}
                    assert over <= 1.0, case
                    assert case["bit_equal_repeat"], case
                    assert dtype != torch.bfloat16 or \
                        case["route"] == "tensor_core", case
                    del y, h, yp, hp, y2, h2
                    if with_h0 and not with_d:
                        want = (("ssd_scan_kernel",)
                                if dtype == torch.bfloat16 else ())
                        case["stage_ms"] = ssd_stage_split(kernel, want)
                        assert all(k in case["stage_ms"] for k in want), case
                    nbytes, flops = ssd_work(B, S, H, P, N, min(chunk, S),
                                             x.element_size(), with_h0,
                                             with_d)
                    t_bytes = nbytes / MEM_BW * 1e3
                    t_ops = flops / PEAK[dtype] * 1e3
                    case.update(kernel_ms=cuda_ms(kernel, reps[0], flush),
                                plain_ms=cuda_ms(plain, reps[1], flush),
                                bound_ms=max(t_bytes, t_ops),
                                bound_by=("bytes" if t_bytes >= t_ops
                                          else "operations"),
                                bytes=nbytes, flops=flops, library_ms=None)
                    cases.append(case)
                    emit({"phase": "ssd_kernel", **case})
    del flush
    torch.cuda.empty_cache()
    return cases


# ========================================================== decode kernel
K4_TPU = "src/repro/kernels/decode_attention/kernel.py:116"
K4_SRC = "src/repro_torch/kernels/csrc/decode_attention.cu"
K4_KERNELS = ("decode_span_kernel", "decode_combine_kernel")
# (arch, B, S, H, K, D, window, softcap, kind, kv dtypes): zamba2-2.7b's
# shared attention over the serve phase's 8 slots of 8192, rows filled to
# the serve traffic's lengths; gemma2-9b's local layer on a 4096-slot ring
# (positions wrapped past it, window 4096) and its global layer on 8192
# slots, each at every cache dtype; llama4-maverick's widths (H 40, K 8,
# D 128: G = 5) and h2o-danube-1.8b's (H 32, K 8, D 80: G = 4, its 4096
# window on a 4096-slot ring), the GQA groups that do not divide 8 or that
# no other case has; the embeds configs' MHA at D = 64 and 96 over 8192
# slots
FILLS = (8192, 4532, 2080, 2080, 1332, 332, 49, 7000)
RING_LAST = (9000, 5000, 4200, 4096, 4095, 3000, 100, 20)
DECODE_CASES = [
    ("zamba2-2.7b", 8, 8192, 32, 32, 160, None, None, "partial",
     ("bfloat16", "float32")),
    ("gemma2-9b", 8, 4096, 16, 8, 256, 4096, 50.0, "ring",
     ("float32", "bfloat16", "int8", "fp8_e4m3")),
    ("gemma2-9b", 8, 8192, 16, 8, 256, None, 50.0, "partial",
     ("float32", "bfloat16", "int8", "fp8_e4m3")),
    ("llama4-maverick-400b-a17b", 8, 8192, 40, 8, 128, None, None, "partial",
     ("bfloat16", "int8")),
    ("h2o-danube-1.8b", 8, 4096, 32, 8, 80, 4096, None, "ring",
     ("bfloat16",)),
    ("musicgen-large", 8, 8192, 32, 32, 64, None, None, "partial",
     ("bfloat16",)),
    ("phi-3-vision-4.2b", 8, 8192, 32, 32, 96, None, None, "partial",
     ("bfloat16",))]
DECODE_BOUND = (
    "max(bytes / 3.35e12 B/s, flops / peak[q dtype]); bytes = the visible "
    "slots' K and V rows, K*2*D*kv_itemsize each (+ 8*K of scales for "
    "int8/fp8) + cache_pos B*S*4 + q and out 2*B*H*D*q_itemsize + q_pos; "
    "flops = 4*D*H per visible (row, slot); peak 989e12 (bf16) or 67e12 "
    "(f32)")
DECODE_LIBRARY = (
    "one PyTorch call on the same inputs, its masks built outside the timed "
    "region; the port calls none of them: scaled_dot_product_attention with "
    "K and V expanded to H heads and an additive (B, 1, 1, S) mask of -inf "
    "on the slots that are not visible; flex_attention (torch.compile'd) "
    "with the tanh softcap as score_mod and the visible slots as mask_mod "
    "where there is a softcap; none for int8/fp8 caches (no call takes "
    "them with their scales)")


# K4's log-sum-exp output against the plain version's (f32 scores either
# way; the sums run in another order)
DECODE_LSE_TOL = 1e-4


def decode_positions(B, S, kind):
    """(cache_pos (B, S), q_pos (B,)) as numpy: rows filled in slot order
    to FILLS[b] positions ("partial"), or a ring of S slots whose newest
    position is RING_LAST[b] (slot = position % S)."""
    slot = np.arange(S)[None, :]
    if kind == "partial":
        fill = np.asarray(FILLS[:B])[:, None]
        return (np.where(slot < fill, slot, -1).astype(np.int32),
                (fill[:, 0] - 1).astype(np.int32))
    last = np.asarray(RING_LAST[:B])[:, None]
    pos = last - ((last - slot) % S)
    return np.where(pos >= 0, pos, -1).astype(np.int32), \
        last[:, 0].astype(np.int32)


def decode_spans(B, S, H, K, D) -> dict:
    """K4's span axis and workspace at these shapes (the span plan of
    ``ref.py``, which mirrors ``split_kv.cuh``)."""
    from repro_torch.kernels.decode_attention import ref

    n = ref.n_spans(S, ref.K4_SPAN_SLOTS)
    return {"span": ref.K4_SPAN_SLOTS, "n_span": n,
            "workspace_bytes": 4 * ref.workspace_elems(B, K, n, H // K, D)}


def decode_work(pos, qpos, window, H, K, D, kv_item, q_item, quant):
    """K4's own count (``ops.decode_work``), which its meta route also
    reads."""
    from repro_torch.kernels.decode_attention.ops import decode_work

    return decode_work(pos, qpos, window, H, K, D, kv_item, q_item, quant)


def decode_library(q, k, v, vis, cap):
    """K4's function on these inputs as one PyTorch call (see
    ``DECODE_LIBRARY``), in (B, H, 1, D) layout, and the call's name."""
    import torch.nn.functional as F

    H_, K_ = q.shape[1], k.shape[2]
    qt = q[:, :, None, :].contiguous()
    if cap is None:
        kt, vt = (x.repeat_interleave(H_ // K_, dim=2).transpose(1, 2)
                  .contiguous() for x in (k, v))
        bias = torch.zeros(vis.shape, dtype=q.dtype, device=q.device)
        bias.masked_fill_(~vis, float("-inf"))
        bias = bias[:, None, None, :].contiguous()
        return (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias)), "sdpa_mask"
    from torch.nn.attention.flex_attention import create_block_mask

    kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))

    def visible(b, h, qi, kj):
        return vis[b, kj]

    def softcap(s, b, h, qi, kj):
        return cap * torch.tanh(s / cap)

    mask = create_block_mask(visible, vis.shape[0], None, 1, vis.shape[1],
                             device=q.device)
    flex = _compiled_flex()
    return (lambda: flex(qt, kt, vt, score_mod=softcap, block_mask=mask,
                         enable_gqa=True)), "flex_attention"


def decode_kernel_phase(dev, cases=DECODE_CASES, reps=(20, 3)) -> list[dict]:
    """K4 against its plain version on the card at each case's shapes and
    cache dtypes; f32 outputs within the JAX suite's 2e-5, bf16 outputs
    element by element within one rounding of the plain version's f32
    value (as K1 and K2 are held); and a row with nothing visible, where
    both give the average of the row's values."""
    from repro_torch.kernels.decode_attention import ops, quant, ref

    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    emit({"phase": "decode_bound", "bound_ms": DECODE_BOUND,
          "library_ms": DECODE_LIBRARY})
    out_cases = []
    for i, (arch, B, S, H_, K_, D_, window, cap, kind, kv_dtypes) in \
            enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(300 + i)
        q32 = torch.randn((B, H_, D_), generator=g, device=dev)
        k32, v32 = (torch.randn((B, S, K_, D_), generator=g, device=dev)
                    for _ in range(2))
        pos_np, qpos_np = decode_positions(B, S, kind)
        pos, qpos = (torch.from_numpy(a).to(dev) for a in (pos_np, qpos_np))
        for kv_dtype in kv_dtypes:
            ks = vs = None
            if kv_dtype == "float32":
                q, k, v, tol = q32, k32, v32, 2e-5
            else:
                q, tol = q32.to(torch.bfloat16), 2e-2
                if kv_dtype == "bfloat16":
                    k, v = k32.to(torch.bfloat16), v32.to(torch.bfloat16)
                else:
                    k, ks = quant.quantize_kv(k32, kv_dtype)
                    v, vs = quant.quantize_kv(v32, kv_dtype)
            kw = dict(k_scale=ks, v_scale=vs, window=window, softcap=cap)
            if ks is None:
                plain = lambda q=q, k=k, v=v: ref.decode_attention_ref(
                    q, k, v, qpos, pos, window=window, softcap=cap)
            else:
                plain = lambda q=q, k=k, v=v: ref.decode_attention_quant_ref(
                    q, k, v, ks, vs, qpos, pos, window=window, softcap=cap)
            nbytes, flops, vis = decode_work(pos_np, qpos_np, window, H_, K_,
                                             D_, k.element_size(),
                                             q.element_size(), ks is not None)
            case, out = checked_case(
                lambda q=q, k=k, v=v: ops.decode_attention(q, k, v, qpos, pos,
                                                           **kw),
                plain, tol, nbytes, flops, q.dtype, flush, reps,
                plain32=(None if kv_dtype == "float32"
                         else lambda: plain(q.float())),
                arch=arch, B=B, S=S, H=H_, K=K_, D=D_, kind=kind,
                kv_dtype=kv_dtype, q_dtype=str(q.dtype).split(".")[1],
                window=window, softcap=cap, visible_slots=int(vis.sum()),
                **decode_spans(B, S, H_, K_, D_))
            assert out.dtype == q.dtype and out.shape == q.shape
            # with its log-sum-exp (the merge of a cache split over the
            # sequence): the same output bit for bit, the lse within
            # DECODE_LSE_TOL of the plain version's
            got, lse = ops.decode_attention(q, k, v, qpos, pos, lse=True,
                                            **kw)
            want = (ref.decode_attention_ref(q, k, v, qpos, pos,
                                             window=window, softcap=cap,
                                             lse=True)[1] if ks is None else
                    ref.decode_attention_quant_ref(
                        q, k, v, ks, vs, qpos, pos, window=window,
                        softcap=cap, lse=True)[1])
            assert bit_equal(got, out)
            assert torch.equal(torch.isinf(lse), torch.isinf(want))
            fin = torch.isfinite(want)
            lse_err = (lse[fin] - want[fin]).abs().max().item()
            assert lse_err <= DECODE_LSE_TOL, (arch, kv_dtype, lse_err)
            case["lse_max_abs_err"] = lse_err
            if ks is None:
                lib, lib_name = decode_library(
                    q, k, v, torch.from_numpy(vis).to(dev), cap)
                lib_err = (lib()[:, :, 0].float()
                           - out.float()).abs().max().item()
                case.update(library=lib_name,
                            library_ms=cuda_ms(lib, reps[0], flush),
                            library_vs_kernel_max_abs_err=lib_err)
                del lib
            else:
                case.update(library=None, library_ms=None)
            out_cases.append(case)
            emit({"phase": "decode_kernel", **case})
        del q32, k32, v32
    # nothing visible in row 0 (an empty cache); row 1 sees its first slot
    q, k, v = (torch.randn(shape, device=dev) for shape in
               ((2, 8, 64), (2, 300, 4, 64), (2, 300, 4, 64)))
    pos = torch.full((2, 300), -1, dtype=torch.int32, device=dev)
    pos[1, 0] = 0
    qpos = torch.tensor([9, 0], dtype=torch.int32, device=dev)
    got, lse = ops.decode_attention(q, k, v, qpos, pos, lse=True)
    want = ref.decode_attention_ref(q, k, v, qpos, pos)
    err = (got - want).abs().max().item()
    assert err <= 2e-5, ("empty row", err)
    assert torch.isneginf(lse[0]).all() and torch.isfinite(lse[1]).all()
    emit({"phase": "decode_empty_row", "max_abs_err": err})
    del flush
    torch.cuda.empty_cache()
    return out_cases


# ================================================================ ssm check
def ssm_check_phase(dev, S=1000) -> list[dict]:
    """mamba2-1.3b at full width cut to 2 layers, and zamba2-2.7b cut to
    one group (6 mamba layers + 1 shared-attention application): the last
    logits of ``forward`` over S + 1 tokens (K3 without h0, K2) against
    ``prefill`` over S tokens then ``decode_step`` on token S + 1 (K3's
    h_final, the conv window and K4 carrying the state)."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.ssd import ops as sd
    from repro_torch.configs.registry import get_config
    from repro_torch.models import decode_step, forward, layer_specs, prefill

    out = []
    for arch, n_layers in (("mamba2-1.3b", 2), ("zamba2-2.7b", 6)):
        cfg = get_config(arch).replace(n_layers=n_layers)
        params = _seeded_params(cfg, dev, 8)
        toks, pos = _prompt(cfg.vocab_size, S + 1, 9, dev)
        whole = forward(params, toks, pos, cfg)[0][:, -1]
        da.decode_attention.launches = sd.ssd.launches = 0
        _, caches = prefill(params, toks[:, :S], pos[:, :S], cfg,
                            max_len=2048)
        stepped, _ = decode_step(params, caches, toks[:, S], pos[:, S:], cfg)
        torch.cuda.synchronize()
        kinds = [spec.kind for spec in layer_specs(cfg)]
        assert sd.ssd.launches == kinds.count("mamba")
        assert da.decode_attention.launches == kinds.count("shared_attn")
        assert bool(torch.isfinite(stepped).all())
        err = (whole - stepped).abs().max().item()
        scale = whole.abs().max().item()
        # bf16 activations: one rounding of an attention or scan output,
        # carried through the layers, as in the score check
        assert err <= 2e-2 * scale, (arch, err, scale)
        res = {"phase": "ssm_check", "arch": arch, "layers": n_layers,
               "prompt": S, "max_abs_err": err, "logit_scale": scale,
               "argmax_equal": bool(torch.equal(whole.argmax(-1),
                                                stepped.argmax(-1)))}
        assert res["argmax_equal"], res
        emit(res)
        out.append(res)
        del params, caches
        torch.cuda.empty_cache()
    return out


def w1_phase(dev, S=1000) -> dict:
    """What sets ``ssm_check``'s mamba2 difference (ROADMAP W1), on the
    same 2-layer model and tokens: the check with the bf16 weights widened
    to f32 and f32 activations; the bf16 check with K3's plain version in
    the kernel's place; and K3's own error against its plain version on the
    inputs each of its calls got in the bf16 check (forward, then prefill),
    as ``err_over_tol`` against ``SSD_TOL``.  Informational: ``ssm_check``
    holds the bounds."""
    import types

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.ssd import ops as sd
    from repro_torch.kernels.ssd import ref as sd_ref
    from repro_torch.models import decode_step, forward, mamba2, prefill

    cfg = get_config("mamba2-1.3b").replace(n_layers=2)
    params = _seeded_params(cfg, dev, 8)
    toks, pos = _prompt(cfg.vocab_size, S + 1, 9, dev)

    def check(p, c, scan):
        mamba2.ssd_ops = types.SimpleNamespace(ssd=scan)
        try:
            whole = forward(p, toks, pos, c)[0][:, -1].float()
            _, caches = prefill(p, toks[:, :S], pos[:, :S], c, max_len=2048)
            stepped = decode_step(p, caches, toks[:, S], pos[:, S:],
                                  c)[0].float()
        finally:
            mamba2.ssd_ops = sd
        assert bool(torch.isfinite(stepped).all())
        return {"max_abs_err": (whole - stepped).abs().max().item(),
                "logit_scale": whole.abs().max().item(),
                "argmax_equal": bool(torch.equal(whole.argmax(-1),
                                                 stepped.argmax(-1)))}

    calls = []

    def recording(*a, **kw):
        calls.append((a, kw))
        return sd.ssd(*a, **kw)

    res = {"phase": "w1", "arch": cfg.name, "layers": cfg.n_layers,
           "prompt": S, "bf16": check(params, cfg, recording),
           "bf16_plain_k3": check(
               params, cfg,
               lambda *a, chunk, h0=None: sd_ref.ssd_chunked_ref(
                   *a, chunk=chunk, h0=h0))}
    atol, rtol = SSD_TOL
    k3 = []
    for a, kw in calls:
        (y, h), (yp, hp) = sd.ssd(*a, **kw), sd_ref.ssd_chunked_ref(*a, **kw)
        k3.append({"S": a[0].shape[1], "h0": kw.get("h0") is not None,
                   "max_abs_err": max((y - yp).abs().max().item(),
                                      (h - hp).abs().max().item()),
                   "err_over_tol": max(
                       ((y - yp).abs() / (atol + rtol * yp.abs())).max()
                       .item(),
                       ((h - hp).abs() / (atol + rtol * hp.abs())).max()
                       .item()),
                   "y_scale": yp.abs().max().item()})
    res["k3_vs_plain"] = k3
    del calls
    widen = lambda t: t.float() if t.dtype == torch.bfloat16 else t
    params32 = _map_leaves(params, widen)
    del params
    res["f32"] = check(params32, cfg.replace(dtype="float32"), sd.ssd)
    emit(res)
    del params32
    torch.cuda.empty_cache()
    return res


# ============================================================ dense serve
DENSE_PROMPTS = (2048, 2048, 2048, 2048, 4500, 17, 300, 1000)


def dense_requests(vocab: int):
    """Four 2048-token prompts (one batched prefill of 4), then 4500 (a
    ragged last chunk), 17, 300 and 1000: five prefill batches in all, in
    the first tick (the engine's scheduler admits up to 8 prefills a tick);
    32 greedy new tokens each."""
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(7)
    return [Request(request_id=f"d{i}", session_key=f"d{i}",
                    prompt=rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=32)
            for i, n in enumerate(DENSE_PROMPTS)]


def _kernel_counters():
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as sd

    return {"K2": fa.flash_attention, "K3": sd.ssd, "K4": da.decode_attention}


def serve_dense_once(cfg, params, dev, smi: str, reqs=None, **kw) -> dict:
    from repro_torch.models import layer_specs
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.scheduler import Scheduler

    base = allocated_outside_workspaces()
    eng = ServeEngine(cfg, params, n_slots=8, max_len=8192, paged=False,
                      scheduler=Scheduler(prefill_budget=8), device=dev, **kw)
    cache_bytes = sum(t.numel() * t.element_size() for c in eng.cm.caches
                      for t in c.values())
    done = []
    eng.on_complete = done.append
    full = reqs is None
    reqs = dense_requests(cfg.vocab_size) if full else reqs
    counters = _kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.monotonic()
    with syncs_forbidden(eng):
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    s = eng.stats
    kinds = [spec.kind for spec in layer_specs(cfg)]
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("shared_attn")
    assert len(done) == len(reqs) and all(r.error is None for r in done)
    assert all(len(r.tokens) == r.max_new_tokens for r in done)
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.tokens)
    assert all(np.isfinite(r.scores).all() for r in done)
    assert s.host_syncs == s.decode_ticks + s.prefill_batches, s
    assert not full or s.prefill_batches == 5, s.prefill_batches
    assert launches["K3"] == n_mamba * s.prefill_batches, launches
    assert launches["K4"] == n_attn * s.decode_ticks, launches
    assert launches["K2"] == n_attn * s.prefill_batches, launches
    res = {"phase": "serve_dense", "arch": cfg.name, "card": smi,
           "temperature": kw.get("temperature", 0.0),
           "n_layers": cfg.n_layers, "mamba_layers": n_mamba,
           "shared_attn_applications": n_attn, "cache_bytes": cache_bytes,
           "prefill_batches": s.prefill_batches,
           "decode_ticks": s.decode_ticks, "host_syncs": s.host_syncs,
           **check_graphs(eng, s.decode_ticks),
           "launches": launches, "tokens_out": s.tokens_out,
           "prompt_tokens": s.prompt_tokens, "wall_s": wall,
           "tokens_per_s": s.tokens_out / wall,
           "ttft_p50_s": statistics.median(s.ttft_s),
           "tpot_p50_s": statistics.median(s.tpot_s),
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    res["streams"] = {r.request_id: list(r.tokens) for r in done}
    ref = graph_ref(eng)
    del eng
    res["kept_after_delete_bytes"] = check_dropped(ref, base)
    emit({k: v for k, v in res.items() if k != "streams"})
    return res


def serve_dense_trace(cfg, params, dev, cuda_graphs: bool) -> dict:
    """The dense serve again under torch.profiler: device time by kernel
    group, the device's idle share, and K2's, K3's and K4's launches by
    their wrappers' counts (held exactly: mamba layers x prefill_batches,
    shared-attention applications x prefill_batches and x decode_ticks) and
    K3's and K4's as the trace counts them (one pass kernel per K3 call,
    one combine kernel per K4 call; at most 1 % of the records dropped,
    else the run again: ``retraced``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import layer_specs
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.scheduler import Scheduler

    def trace_once():
        base = allocated_outside_workspaces()
        eng = ServeEngine(cfg, params, n_slots=8, max_len=8192, paged=False,
                          scheduler=Scheduler(prefill_budget=8), device=dev,
                          cuda_graphs=cuda_graphs)
        for r in dense_requests(cfg.vocab_size):
            eng.submit(r)
        counters = _kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            eng.run_until_drained()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        s = eng.stats
        launches = {k: fn.launches for k, fn in counters.items()}
        kinds = [spec.kind for spec in layer_specs(cfg)]
        n_mamba, n_attn = kinds.count("mamba"), kinds.count("shared_attn")
        assert launches == {"K2": n_attn * s.prefill_batches,
                            "K3": n_mamba * s.prefill_batches,
                            "K4": n_attn * s.decode_ticks}, (launches, s)
        traced = {"K3": kernel_launches(prof, ("ssd_pass_kernel",)),
                  "K4": kernel_launches(prof, ("decode_combine_kernel",))}
        res = {"phase": "serve_dense_trace", "arch": cfg.name,
               "cuda_graphs": cuda_graphs, "ticks": s.ticks,
               "launches": launches, "launches_traced": traced,
               **_device_time(prof, wall, {"K2": ("flash_attention",),
                                           "K3": ("ssd_",),
                                           "K4": K4_KERNELS,
                                           "gemm": GEMM_KEYS})}
        ref = graph_ref(eng)
        del eng, prof
        check_dropped(ref, base)
        return res, {k: launches[k] for k in traced}, traced

    return retraced(trace_once)


def serve_dense_phase(dev, smi: str) -> dict:
    """``ServeEngine(paged=False)`` on mamba2-1.3b and zamba2-2.7b at full
    width and depth, bf16, seeded weights, 8 slots of 8192 positions:
    captured, then eager in the same call (the greedy streams must be
    equal), a short sampled serve both ways (equal streams too), and each
    way under the profiler."""
    from repro_torch.configs.registry import get_config

    runs = {}
    for arch in ("mamba2-1.3b", "zamba2-2.7b"):
        cfg = get_config(arch)
        params = _seeded_params(cfg, dev, 0)
        n_params = sum(t.numel() for t in _leaves(params))
        assert n_params == cfg.param_count(), (n_params, cfg.param_count())
        runs[arch] = serve_dense_once(cfg, params, dev, smi)
        eager = serve_dense_once(cfg, params, dev, smi, cuda_graphs=False)
        assert eager["streams"] == runs[arch]["streams"], \
            f"{arch}: captured and eager streams differ"
        again = serve_dense_once(cfg, params, dev, smi)
        assert again["streams"] == runs[arch]["streams"], \
            f"{arch}: a second captured run differs"
        sampled = {}
        for graphs in (True, False):
            few = [r for r in dense_requests(cfg.vocab_size)
                   if len(r.prompt) in (17, 300)]
            sampled[graphs] = serve_dense_once(
                cfg, params, dev, smi, reqs=few, temperature=1.0,
                cuda_graphs=graphs)["streams"]
        assert sampled[True] == sampled[False], f"{arch}: sampled differ"
        traced = {graphs: serve_dense_trace(cfg, params, dev, graphs)
                  for graphs in (True, False)}
        graphs_line(f"dense {arch}", smi, runs[arch],
                    dict(again, **traced[True]), dict(eager, **traced[False]))
        del params
        torch.cuda.empty_cache()
    return runs


# ============================================================ preempt
# gemma2-9b at full depth under block pressure: six batch requests (900
# prompt tokens, 64 new: 61 blocks each at most) fill a tight pool of 400
# blocks; then an interactive request (1,500 tokens, 32 new: 96 blocks)
# arrives, which cannot issue until two of them are evicted
PREEMPT_BLOCKS = 400
PREEMPT_SPILL_CAP = 256          # blocks the store-backed pool may park
PREEMPT_REFUSING_CAP = 32        # below one victim: every park refused
STEPS_B, STEPS_S, STEPS_NEW = 4, 1000, 16


def preempt_batch(vocab: int):
    from repro_torch.serving.scheduler import SLO_BATCH, Request

    rng = np.random.default_rng(11)
    return [Request(request_id=f"b{i}", session_key=f"b{i}",
                    prompt=rng.integers(0, vocab, 900).astype(np.int32),
                    max_new_tokens=64, slo=SLO_BATCH) for i in range(6)]


def preempt_interactive(vocab: int):
    """Made when it is submitted: its TTFT counts from then."""
    from repro_torch.serving.scheduler import SLO_INTERACTIVE, Request

    rng = np.random.default_rng(12)
    return Request(request_id="i0", session_key="i0",
                   prompt=rng.integers(0, vocab, 1500).astype(np.int32),
                   max_new_tokens=32, slo=SLO_INTERACTIVE)


def tick_until_live(eng, n: int, max_ticks: int = 200) -> None:
    """Tick until ``n`` requests decode, each with a token out."""
    for _ in range(max_ticks):
        if len(eng.live) == n and all(r.tokens for r in eng.live.values()):
            return
        eng.tick()
    raise TimeoutError(f"{n} requests never went live")


@contextlib.contextmanager
def timed_moves(eng):
    """Inside the block, time each of the engine's ``spill`` and ``adopt``
    calls (its preemption, resume and failover paths make them): a spill
    by the host clock (it ends in the engine's one pull, so the clock
    covers the gather and the copy), an adoption by CUDA events around the
    call (the host's packing, the non-blocking upload and the scatter, in
    stream order; read them with ``adopt_times`` after a synchronize).
    Yields the two lists it fills."""
    spills, adopts = [], []
    spill, adopt = eng.spill, eng.adopt

    def timed_spill(slot):
        t0 = time.perf_counter()
        out = spill(slot)
        dt = time.perf_counter() - t0
        if out is not None:
            spills.append({"request": out.request_id, "blocks": out.n_blocks,
                           "nbytes": out.nbytes, "ms": dt * 1e3,
                           "gb_per_s": out.nbytes / dt / 1e9})
        return out

    def timed_adopt(req, spilled):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        ok = adopt(req, spilled)
        e.record()
        adopts.append((req.request_id, spilled.n_blocks if spilled else 0,
                       spilled.nbytes if spilled else 0, ok, s, e,
                       time.perf_counter() - t0))
        return ok

    eng.spill, eng.adopt = timed_spill, timed_adopt
    try:
        yield spills, adopts
    finally:
        del eng.spill, eng.adopt


def adopt_times(adopts) -> list[dict]:
    """``timed_moves``'s adoptions, their events read (after a
    synchronize)."""
    return [{"request": rid, "adopted": ok, "blocks": n_blocks,
             "nbytes": nbytes, "ms": s.elapsed_time(e), "host_ms": host * 1e3,
             "gb_per_s": (nbytes / (s.elapsed_time(e) * 1e-3) / 1e9
                          if nbytes else None)}
            for rid, n_blocks, nbytes, ok, s, e, host in adopts]


def assert_drained_exactly(eng) -> None:
    """``tests/test_preempt_resume.py:_assert_drained_exactly``: with the
    prefix cache off a drained pool holds nothing, every slot is free and
    the free list holds each block once (a double free would repeat one)."""
    alloc = eng.cm.alloc
    assert alloc.blocks_in_use == 0
    assert all(not s.active for s in eng.cm.slots)
    assert len(alloc.free) == len(set(alloc.free)) == eng.cm.num_blocks - 1
    assert eng.cm.available_for_admission() == alloc.available()


def pool_ptrs(eng) -> list[int]:
    return [t.data_ptr() for pool in eng.cm.pools for t in pool.values()]


def preempt_once(cfg, params, dev, *, num_blocks: int, preempt: bool,
                 spill_pool=None) -> dict:
    """The six batch requests until each decodes, then the interactive
    one, all under the sync check; every pool leaf keeps its storage."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.serving.engine import ServeEngine

    base = allocated_outside_workspaces()
    eng = ServeEngine(cfg, params, n_slots=8, token_budget=512, max_len=8192,
                      num_blocks=num_blocks, prefix_cache=False,
                      preempt=preempt, spill_pool=spill_pool, device=dev)
    done = {}
    eng.on_complete = lambda r: done.setdefault(r.request_id, r)
    ptrs = pool_ptrs(eng)
    torch.cuda.synchronize()
    ops.ragged_paged_attention.launches = 0
    t0 = time.monotonic()
    with timed_moves(eng) as (spills, adopts), syncs_forbidden(eng):
        for r in preempt_batch(cfg.vocab_size):
            eng.submit(r)
        tick_until_live(eng, 6)
        inter = preempt_interactive(cfg.vocab_size)
        eng.submit(inter)
        eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.ragged_paged_attention.launches
    adopts = adopt_times(adopts)
    s = eng.stats
    assert len(done) == 7 and all(r.error is None for r in done.values())
    assert all(len(r.tokens) == r.max_new_tokens for r in done.values())
    assert launches == s.ticks * cfg.n_layers, (launches, s.ticks)
    assert s.host_syncs == s.ticks + s.spill_syncs, s
    assert pool_ptrs(eng) == ptrs, "a pool leaf was rebound"
    assert_drained_exactly(eng)
    res = {"num_blocks": num_blocks, "preempt": preempt,
           "spill_pool_blocks": getattr(spill_pool, "capacity_blocks", None),
           "ticks": s.ticks, "host_syncs": s.host_syncs,
           "spill_syncs": s.spill_syncs, "preemptions": s.preemptions,
           "resumes": s.resumes, "adopted_sessions": s.adopted_sessions,
           "spilled_blocks": s.spilled_blocks, "k1_launches": launches,
           "graph_replays": s.graph_replays, "wall_s": wall,
           "interactive_ttft_s": inter.first_token_s - inter.arrived_s,
           "spills": spills, "adopts": adopts,
           "streams": {rid: list(r.tokens) for rid, r in done.items()}}
    ref = graph_ref(eng)
    del eng
    check_dropped(ref, base)
    return res


def store_retained_bytes(store) -> int:
    """Payload bytes the store still holds in its version chains (a
    tombstone is a new version; the parked one stays in the chain)."""
    return sum(obj.nbytes() for w in store.workers.values()
               for chain in w.volatile.values() for obj in chain)


def preempt_phase(cfg, params, dev, smi: str) -> dict:
    """The four runs of one call: (a) a baseline with 1,024 blocks and no
    pressure; (b) the tight pool with preemption into a store-backed
    ``SpillPool`` under ``/spill/<model>`` (victims resume by adoption);
    (c) preemption into a standalone pool too small for any victim (every
    park refused: victims replay); (d) the tight pool without preemption
    (the interactive request waits)."""
    from repro_torch.core.pools import PoolSpec
    from repro_torch.core.store import CascadeStore, SpillPool, Worker

    t0 = time.monotonic()
    base = preempt_once(cfg, params, dev, num_blocks=1024, preempt=False)
    assert base["preemptions"] == 0
    prefix = f"/spill/{cfg.name}"
    store = CascadeStore([Worker(0, n_upcall_threads=1)])
    try:
        store.create_pool(PoolSpec(path=prefix, replication=1))
        pool = SpillPool(capacity_blocks=PREEMPT_SPILL_CAP, store=store,
                         prefix=prefix)
        parked = preempt_once(cfg, params, dev, num_blocks=PREEMPT_BLOCKS,
                              preempt=True, spill_pool=pool)
        retained = store_retained_bytes(store)
        assert pool.blocks == 0 and pool.parked == pool.unparked
    finally:
        store.close()
    del store, pool
    refusing = SpillPool(capacity_blocks=PREEMPT_REFUSING_CAP)
    replay = preempt_once(cfg, params, dev, num_blocks=PREEMPT_BLOCKS,
                          preempt=True, spill_pool=refusing)
    assert refusing.parked == 0 and refusing.blocks == 0
    waited = preempt_once(cfg, params, dev, num_blocks=PREEMPT_BLOCKS,
                          preempt=False)
    for name, run in (("store", parked), ("replay", replay),
                      ("no preemption", waited)):
        assert run["streams"] == base["streams"], f"{name}: streams differ"
    assert parked["preemptions"] >= 2 and parked["resumes"] >= 2
    assert parked["adopted_sessions"] == parked["resumes"]
    assert len(parked["spills"]) == parked["spill_syncs"] >= 2
    assert replay["preemptions"] >= 2 and replay["resumes"] == 0
    assert waited["preemptions"] == 0
    runs = {"baseline": base, "preempt_store": parked,
            "preempt_replay": replay, "no_preempt": waited}
    res = {"phase": "preempt", "card": smi, "n_layers": cfg.n_layers,
           "kv_dtype": "bfloat16", "cuda_graphs": True,
           "store_retained_bytes": retained,
           "seconds": time.monotonic() - t0,
           "runs": {k: dict({m: v for m, v in r.items()
                             if m not in ("streams", "spills", "adopts")},
                            spill=moves_summary(r["spills"]),
                            adopt=moves_summary(r["adopts"]))
                    for k, r in runs.items()}}
    emit(res)
    # each victim's spills and adoptions, in order, on a line of their own
    print(json.dumps({
        "preempt_summary": smi,
        "interactive_ttft_s": {k: r["interactive_ttft_s"]
                               for k, r in runs.items()},
        "spills": [[x["request"], x["nbytes"], x["ms"], x["gb_per_s"]]
                   for x in parked["spills"]],
        "adopts": [[x["request"], x["nbytes"], x["ms"], x["gb_per_s"]]
                   for x in parked["adopts"] if x["adopted"]],
        "k1_launches": {k: r["k1_launches"] for k, r in runs.items()}}),
        flush=True)
    return base


def moves_summary(moves: list[dict]) -> dict:
    """Count, bytes and the median / least / most ms and GB/s of spills or
    adoptions."""
    if not moves:
        return {"n": 0}
    ms = [x["ms"] for x in moves]
    rate = [x["gb_per_s"] for x in moves if x["gb_per_s"] is not None]
    return {"n": len(moves), "nbytes": sorted({x["nbytes"] for x in moves}),
            "ms_median": statistics.median(ms), "ms_min": min(ms),
            "ms_max": max(ms),
            "gb_per_s_median": statistics.median(rate) if rate else None}


def failover_phase(cfg, params, dev, want: dict) -> dict:
    """Engine A serves the six batch requests; a seeded injector crashes it
    at a tick entry once all six decode; ``evacuate(spill_kv=True)`` spills
    them and engine B (the same params, its own pool) adopts each, then
    serves them to the end.  The streams equal the uninterrupted run's."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.faults import (FaultInjector, FaultKind,
                                            FaultSpec, ReplicaCrashed)

    kw = dict(n_slots=8, token_budget=512, max_len=8192, num_blocks=512,
              prefix_cache=False, device=dev)
    a, b = ServeEngine(cfg, params, **kw), ServeEngine(cfg, params, **kw)
    done = {}
    for eng in (a, b):
        eng.on_complete = lambda r: done.setdefault(r.request_id, r)
    ops.ragged_paged_attention.launches = 0
    with timed_moves(a) as (spills, _), syncs_forbidden(a):
        for r in preempt_batch(cfg.vocab_size):
            a.submit(r)
        tick_until_live(a, 6)
        inj = FaultInjector([FaultSpec(FaultKind.CRASH, at_tick=2)], seed=0)
        a.faults = inj.bind(cfg.name, 0)
        a.tick()
        try:
            a.tick()
            raise AssertionError("the injected crash did not fire")
        except ReplicaCrashed:
            pass
        queued, inflight = a.evacuate(spill_kv=True)
    assert a.crashed and not queued and len(inflight) == 6
    migrated = 0
    with timed_moves(b) as (_, adopts), syncs_forbidden(b):
        for req, spilled in inflight:
            if spilled is not None and b.adopt(req, spilled):
                migrated += 1
                continue
            req.fold_for_replay()
            b.submit(req)
        b.run_until_drained()
    torch.cuda.synchronize()
    launches = ops.ragged_paged_attention.launches
    adopts = adopt_times(adopts)
    del inflight
    assert migrated == 6 == b.stats.adopted_sessions
    assert {rid: list(r.tokens) for rid, r in done.items()} == want, \
        "failover streams differ"
    assert a.stats.host_syncs == a.stats.ticks + a.stats.spill_syncs
    assert b.stats.host_syncs == b.stats.ticks
    assert launches == (a.stats.ticks + b.stats.ticks) * cfg.n_layers
    for eng in (a, b):
        assert_drained_exactly(eng)
    res = {"fired": inj.fired_log, "ticks_a": a.stats.ticks,
           "ticks_b": b.stats.ticks, "spill_syncs_a": a.stats.spill_syncs,
           "migrated": migrated, "k1_launches": launches,
           "spill": moves_summary(spills), "adopt": moves_summary(adopts)}
    del a, b
    torch.cuda.empty_cache()
    return res


def workspace_bytes() -> int:
    from repro_torch import kernels

    return sum(b.numel() * b.element_size()
               for b in kernels._workspaces.values())


def step_streams(cfg, params, pools, bt, toks, new: int):
    """``paged_prefill`` of the (B, S) prompts, then ``new`` greedy
    ``paged_decode_step``s: the first-token logits and the B streams."""
    from repro_torch.models import paged_decode_step, paged_prefill

    B, S = toks.shape
    pos = torch.arange(S, dtype=torch.int32, device=toks.device).repeat(B, 1)
    first, _ = paged_prefill(params, pools, bt, toks, pos, cfg)
    out = [first.argmax(-1)]
    for i in range(new):
        qpos = torch.full((B, 1), S + i, dtype=torch.int32, device=toks.device)
        logits, _ = paged_decode_step(params, pools, bt, out[-1], qpos, cfg)
        out.append(logits.argmax(-1))
    return first, torch.stack(out, 1).tolist()


def mixed_first_logits(cfg, params, pools, bt, toks, budget: int = 512):
    """The same prompts through ``paged_mixed_step`` as the engine packs
    them: consecutive ``budget``-lane ticks over the rows' prompt tokens in
    order; each row's logits at its last prompt token."""
    from repro_torch.models import paged_mixed_step

    B, S = toks.shape
    dev = toks.device
    lanes = [(r, p) for r in range(B) for p in range(S)]
    first = [None] * B
    for lo in range(0, len(lanes), budget):
        chunk = lanes[lo:lo + budget]
        rows = torch.full((budget,), -1, dtype=torch.int32)
        pos = torch.full((budget,), -1, dtype=torch.int32)
        sample = torch.zeros(B, dtype=torch.int32)
        for i, (r, p) in enumerate(chunk):
            rows[i], pos[i] = r, p
            if p == S - 1:
                sample[r] = i
        t = torch.zeros(budget, dtype=torch.int32, device=dev)
        t[:len(chunk)] = toks.reshape(-1)[lo:lo + len(chunk)]
        logits = paged_mixed_step(params, pools, bt, t, pos.to(dev),
                                  rows.to(dev), sample.to(dev), cfg)
        for r in {r for r, p in chunk if p == S - 1}:
            first[r] = logits[r]
    return torch.stack(first)


def steps_check(cfg, params, dev) -> dict:
    """``paged_prefill`` of four 1,000-token prompts, then 16
    ``paged_decode_step``s, at full depth in bf16 with the engine's table
    width (max_len 8192): K1 once a layer a step, and the first-token
    logits within 2e-2 x scale of the engine's packed ticks (the ssm_check
    rule).  Then the same at f32 cut to 4 layers, where the greedy streams
    must equal the engine's."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.models import init_paged_pools
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.scheduler import Request

    B, S, new, bs = STEPS_B, STEPS_S, STEPS_NEW, 16
    per_row = -(-(S + new) // bs)
    bt = torch.full((B, 8192 // bs), -1, dtype=torch.int32)
    bt[:, :per_row] = torch.arange(1, 1 + B * per_row).reshape(B, per_row)
    bt = bt.to(dev)
    rng = np.random.default_rng(13)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                            .astype(np.int32)).to(dev)
    ws0 = workspace_bytes()
    pools = init_paged_pools(cfg, 1 + B * per_row, bs, device=dev)
    torch.cuda.synchronize()
    ops.ragged_paged_attention.launches = 0
    t0 = time.monotonic()
    first, streams = step_streams(cfg, params, pools, bt, toks, new)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.ragged_paged_attention.launches
    assert launches == (1 + new) * cfg.n_layers, launches
    ws1 = workspace_bytes()
    assert bool(torch.isfinite(first).all())
    pools2 = init_paged_pools(cfg, 1 + B * per_row, bs, device=dev)
    mixed = mixed_first_logits(cfg, params, pools2, bt, toks)
    err = (first - mixed).abs().max().item()
    scale = mixed.abs().max().item()
    assert err <= 2e-2 * scale, (err, scale)
    del pools, pools2

    f32 = cfg.replace(n_layers=4, dtype="float32")
    p32 = _seeded_params(f32, dev, 5)
    pools = init_paged_pools(f32, 1 + B * per_row, bs, device=dev)
    _, steps32 = step_streams(f32, p32, pools, bt, toks, new)
    eng = ServeEngine(f32, p32, n_slots=8, token_budget=512, max_len=8192,
                      num_blocks=1 + B * per_row, prefix_cache=False,
                      device=dev)
    done = {}
    eng.on_complete = lambda r: done.setdefault(r.request_id, r.tokens)
    for i in range(B):
        eng.submit(Request(request_id=f"p{i}", session_key=f"p{i}",
                           prompt=toks[i].cpu().numpy(),
                           max_new_tokens=1 + new))
    eng.run_until_drained()
    assert [done[f"p{i}"] for i in range(B)] == steps32, \
        "f32: the paged steps' streams differ from the engine's"
    del eng, pools, p32
    torch.cuda.empty_cache()
    return {"B": B, "S": S, "decode_steps": new, "k1_launches": launches,
            "k1_per_step": launches // (1 + new), "wall_s": wall,
            "first_logits_max_abs_err": err, "logit_scale": scale,
            "argmax_equal": bool(torch.equal(first.argmax(-1),
                                             mixed.argmax(-1))),
            "workspace_bytes_before": ws0, "workspace_bytes_after": ws1,
            "f32_4_layers_streams_equal": True}


def preempt_phases(dev, smi: str) -> dict:
    """gemma2-9b at full width and depth, bf16, seeded weights: the
    ``preempt`` phase, then ``failover_and_steps``."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("gemma2-9b")
    params = _seeded_params(cfg, dev, 0)
    base = preempt_phase(cfg, params, dev, smi)
    t0 = time.monotonic()
    want = {rid: s for rid, s in base["streams"].items() if rid != "i0"}
    res = {"phase": "failover_and_steps", "card": smi,
           "failover": failover_phase(cfg, params, dev, want),
           "steps": steps_check(cfg, params, dev)}
    res["seconds"] = time.monotonic() - t0
    emit(res)
    del params
    torch.cuda.empty_cache()
    return res


# ================================================================ cluster
# Cascade's serving layer on one node: a paged light model and a hybrid
# heavy model that share a 32,000-token vocabulary, so every id the light
# model emits is in range for the heavy one's embedding
CLUSTER_LIGHT, CLUSTER_HEAVY = "h2o-danube-1.8b", "zamba2-2.7b"
LIGHT_BLOCK = 16                  # ServeEngine's default block_size
LIGHT_ENGINE = dict(n_slots=8, max_len=8192, token_budget=512,
                    num_blocks=1024)
HEAVY_ENGINE = dict(n_slots=4, max_len=4096, paged=False)
CHAT_USER = (64, 100, 100)        # user tokens a turn; 16 new tokens each
ROUTE_LENGTHS = tuple(int(n) for n in np.linspace(128, 1000, 16))
BURST, FAILOVER_REQUESTS, CRASH_AT_TICK = 24, 8, 5


def node_drain(node, receipts=(), timeout_s: float = 300.0) -> None:
    """``run_until_drained``, failing at the first upcall that raised on a
    worker thread (the dispatcher contains it; the drain would only time
    out), with the error of a client receipt that carries one."""
    step = node.step

    def checked() -> int:
        busy = step()
        errors = sum(w.dispatcher.stats()["upcall_errors"]
                     for w in node.workers)
        if errors:
            raised = [ev.error for r in receipts for ev in r.events
                      if ev.error is not None]
            raise RuntimeError(f"{errors} upcall(s) raised on a worker "
                               f"thread: {raised[:1]!r}")
        return busy

    node.step = checked
    try:
        node.run_until_drained(timeout_s)
    finally:
        del node.step


def wait_all(receipts) -> None:
    """Wait for every client put's upcall (the engine holds the request)."""
    for rc in receipts:
        rc.wait()


def arrive_during_captures(engines, inject) -> None:
    """Every capture of these engines' ticks runs ``inject(engine)`` between
    ``capture_begin`` and ``capture_end``: a client submit whose upcall runs
    on a worker thread (admission, the engine's ``submit``) while the graph
    is being captured in the global capture mode."""
    for eng in engines:
        runner = eng._tick_runner
        capture = runner._capture

        def with_arrival(step, capture=capture, eng=eng):
            def step_and_arrival():
                step()
                inject(eng)
            capture(step_and_arrival)

        runner._capture = with_arrival


def kv_versions(dep, ds) -> list[dict]:
    """Each replica's pool key: its version against ticks + adoptions, and
    whether the stored leaves are the engine's pool tensors."""
    out = []
    for r, eng in enumerate(dep.engines):
        key = f"/kv/{dep.name}/replica{r}/pool"
        stored = ds.get(key)
        out.append({"key": key, "latest_version": ds.latest_version(key),
                    "ticks": eng.stats.ticks,
                    "adoptions": eng.stats.adopted_sessions,
                    "same_tensors": [t.data_ptr() for layer in stored
                                     for t in layer.values()]
                    == pool_ptrs(eng)})
    return out


def tier_stats(dep) -> dict:
    st = dep.stats()
    keep = ("requests", "tokens_out", "ticks", "decode_ticks",
            "prefill_batches", "host_syncs", "prefix_hit_tokens", "shed",
            "redirected", "failovers", "rehomed", "migrated", "replayed",
            "ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s")
    return {**{k: st[k] for k in keep}, "queue_wait_s": st["queue_wait_s"],
            "per_replica_requests": st["per_replica_requests"],
            "graph_captures": sum(e.stats.graph_captures
                                  for e in dep.engines),
            "graph_capture_s": sum(e.stats.graph_capture_s
                                   for e in dep.engines)}


def direct_streams(cfg, params, dev, sent: dict, **kw) -> dict:
    """The same prompts through one engine of the same shape, outside the
    node: request id -> greedy stream."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.scheduler import Request

    eng = ServeEngine(cfg, params, device=dev, **kw)
    done = {}
    eng.on_complete = lambda r: done.setdefault(r.request_id, list(r.tokens))
    for rid, (prompt, new) in sent.items():
        eng.submit(Request(request_id=rid, session_key=rid, prompt=prompt,
                           max_new_tokens=new))
    eng.run_until_drained(max_ticks=100_000)
    assert len(done) == len(sent)
    del eng
    return done


def first_difference(a: list, b: list) -> int | None:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def cluster_single_tenant(dev, smi: str, direct: dict) -> dict:
    """``ServeCluster(gemma2-9b, n_replicas=1)`` on the serve phase's eight
    requests: the direct engine's captured greedy streams, bit for bit."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.serving.cluster import ServeCluster

    cfg = get_config("gemma2-9b")
    params = _seeded_params(cfg, dev, 0)
    reqs = serve_requests(cfg.vocab_size)
    cluster = ServeCluster(cfg, params, n_replicas=1, device=dev,
                           **LIGHT_ENGINE)
    eng = cluster.engines[0]
    torch.cuda.synchronize()
    ops.ragged_paged_attention.launches = 0
    t0 = time.monotonic()
    with syncs_forbidden(eng):
        receipts = [cluster.submit(r.session_key, r.request_id, r.prompt,
                                   max_new_tokens=r.max_new_tokens)
                    for r in reqs]
        wait_all(receipts)             # one queue, as the direct engine had
        node_drain(cluster.node, receipts)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.ragged_paged_attention.launches
    st = cluster.stats()
    streams = {r.request_id: cluster.result(r.request_id).tolist()
               for r in reqs}
    assert streams == direct["streams"], {
        rid: first_difference(streams[rid], direct["streams"][rid])
        for rid in streams}
    assert st["host_syncs"] == st["ticks"], st
    assert launches == st["ticks"] * cfg.n_layers, (launches, st["ticks"])
    ds = cluster.kv_store
    assert ds.donate_misses == 0
    assert ds.latest_version(f"/kv/{cfg.name}/replica0/pool") == st["ticks"]
    res = {"phase": "cluster_single", "arch": cfg.name, "card": smi,
           "ticks": st["ticks"], "host_syncs": st["host_syncs"],
           "k1_launches": launches, "streams_equal_direct": True,
           "kv_latest_version": ds.latest_version(
               f"/kv/{cfg.name}/replica0/pool"),
           "wall_s": wall,
           "node": {"ttft_p50_s": st["ttft_p50_s"],
                    "tpot_p50_s": st["tpot_p50_s"],
                    "queue_wait_s": st["queue_wait_s"]},
           "direct": {"ttft_p50_s": direct["ttft_p50_s"],
                      "tpot_p50_s": direct["tpot_p50_s"]}}
    cluster.close()
    # the receipts' events hold the serving lambda, so the deployment and
    # its engines: all of it goes here, not at some later collection
    del cluster, eng, params, ds, receipts
    gc.collect()
    torch.cuda.empty_cache()
    emit(res)
    return res


def cluster_tenants(dev, smi: str) -> dict:
    """Two tenants on one ``ServeNode(n_workers=2)``: chat sessions and a
    calibrated cascade, overload, a failover, then the light tier's
    teardown."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.placement import LRUCache
    from repro_torch.core.pools import DispatchPolicy
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.models import layer_specs
    from repro_torch.serving.cluster import (CascadeGate, CascadeRoute,
                                             ServeNode)
    from repro_torch.serving.faults import (FaultInjector, FaultKind,
                                            FaultSpec)

    t_phase = time.monotonic()
    lcfg, hcfg = get_config(CLUSTER_LIGHT), get_config(CLUSTER_HEAVY)
    assert lcfg.vocab_size == hcfg.vocab_size, (lcfg.vocab_size,
                                                hcfg.vocab_size)
    V = lcfg.vocab_size
    lparams, hparams = _seeded_params(lcfg, dev, 1), _seeded_params(hcfg,
                                                                    dev, 2)
    kinds = [spec.kind for spec in layer_specs(hcfg)]
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("shared_attn")
    counters = {"K1": da.ragged_paged_attention, **_kernel_counters()}
    rng, arrival_rng = np.random.default_rng(31), np.random.default_rng(32)
    node = ServeNode(n_workers=2, device=dev)
    light = node.deploy("light", lcfg, lparams, n_replicas=2,
                        policy=DispatchPolicy.FIFO, **LIGHT_ENGINE)
    heavy = node.deploy("heavy", hcfg, hparams, n_replicas=2, **HEAVY_ENGINE)
    assert all(e.params is lparams for e in light.engines)
    assert all(e.params is hparams for e in heavy.engines)
    engines = light.engines + heavy.engines
    light_sent, heavy_sent = {}, {}     # held against direct engines
    receipts, arrivals = [], []

    def inject(eng):
        dep = light if eng in light.engines else heavy
        rid = f"arrival{len(arrivals)}"
        p = arrival_rng.integers(0, V, 40 + 7 * len(arrivals)).astype(
            np.int32)
        (light_sent if dep is light else heavy_sent)[rid] = (p, 16)
        dep.submit(rid, rid, p, max_new_tokens=16).wait()
        arrivals.append({"capturing": f"{dep.name}/replica"
                         f"{dep.engines.index(eng)}", "request": rid,
                         "routed": dep.routed[rid]})

    arrive_during_captures(engines, inject)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.monotonic()
    with syncs_forbidden(*engines):
        # chat: three sessions x three turns, each turn on its history
        history = {f"chat{s}": np.zeros(0, np.int32) for s in range(3)}
        for turn, n_user in enumerate(CHAT_USER):
            wave = []
            for s in history:
                history[s] = np.concatenate(
                    [history[s], rng.integers(0, V, n_user).astype(np.int32)])
                rid = f"{s}-t{turn}"
                light_sent[rid] = (history[s], 16)
                wave.append(light.submit(s, rid, history[s],
                                         max_new_tokens=16))
            receipts += wave
            wait_all(wave)
            node_drain(node, receipts)
            for s in history:
                history[s] = np.concatenate(
                    [history[s], light.result(f"{s}-t{turn}")])
        chat = {s: sorted({light.routed[f"{s}-t{t}"] for t in range(3)})
                for s in history}
        assert all(len(r) == 1 for r in chat.values()), chat
        chat_hits = light.stats()["prefix_hit_tokens"]
        assert chat_hits > 0
        # cascade: a probe pass calibrates the gate at its median
        prompts = {f"q{i}": rng.integers(0, V, n).astype(np.int32)
                   for i, n in enumerate(ROUTE_LENGTHS)}
        probe = {}

        def listener(req):
            if req.request_id.startswith("probe-"):
                probe[req.request_id] = req.mean_logprob()

        light.on_done.append(listener)
        wave = [light.submit(rid, f"probe-{rid}", p, max_new_tokens=32)
                for rid, p in prompts.items()]
        wait_all(wave)
        node_drain(node, receipts + wave)
        light.on_done.remove(listener)
        threshold = float(np.median(list(probe.values())))
        route = CascadeRoute(light, heavy, CascadeGate("logprob", threshold),
                             escalate_on_error=True)
        wave = [route.submit(rid, rid, p, max_new_tokens=32)
                for rid, p in prompts.items()]
        for rid, p in prompts.items():
            light_sent[f"probe-{rid}"] = light_sent[rid] = (p, 32)
        receipts += wave
        wait_all(wave)
        node_drain(node, receipts)
        cascade = route.stats()
        assert 0 < cascade["escalation_rate"] < 1, cascade
        for rid, p in prompts.items():
            assert route.result(rid) is not None
            if route.escalated(rid):
                heavy_sent[rid] = (p, 32)
        t_main = time.monotonic() - t0
        ls, hs = tier_stats(light), tier_stats(heavy)
        ds = node.kv_store()
        kv = kv_versions(light, ds)
        # overload: a burst over the light tier's watermark
        light.watermark = 2
        burst = {f"burst{i}": rng.integers(0, V, 64 + 6 * i).astype(np.int32)
                 for i in range(BURST)}
        wave = [route.submit("burst", rid, p, max_new_tokens=8)
                for rid, p in burst.items()]
        receipts += wave
        wait_all(wave)
        node_drain(node, receipts)
        light.watermark = None
        shed = [rid for rid in burst if (light.error(rid) or {}).get(
            "error") == "shed_overload"]
        assert light.redirected > 0 and shed, (light.redirected, shed)
        for rid in burst:
            assert len(route.result(rid)) == 8, rid
            assert route.error(rid) is None, route.error(rid)
        for rid in shed:
            assert route.escalated(rid) and len(heavy.result(rid)) == 8, rid
        overload = {"burst": BURST, "watermark": 2,
                    "redirected": light.redirected, "shed": len(shed),
                    "answered": BURST, "shed_answered_by_heavy": len(shed),
                    "route": route.stats()}
        # failover: light replica 1 crashes mid-drain
        injector = FaultInjector([FaultSpec(FaultKind.CRASH,
                                            deployment="light", replica=1,
                                            at_tick=CRASH_AT_TICK)], seed=0)
        light.install_faults(injector)
        fo = {f"fo{i}": rng.integers(0, V, 100 + 25 * i).astype(np.int32)
              for i in range(FAILOVER_REQUESTS)}
        wave = [light.submit(rid, rid, p, max_new_tokens=16)
                for rid, p in fo.items()]
        for rid, p in fo.items():
            light_sent[rid] = (p, 16)
        receipts += wave
        wait_all(wave)
        on_1 = [rid for rid in fo if light.routed[rid] == 1]
        assert on_1, light.routed
        node_drain(node, receipts)
        fst = light.stats()
        assert fst["failovers"] == 1 and fst["migrated"] >= 1, fst
        assert all(len(light.result(rid)) == 16 for rid in fo)
        failover = {k: fst[k] for k in ("failovers", "rehomed", "migrated",
                                        "replayed", "failover_failed",
                                        "spill_syncs", "adopted_sessions")}
        failover.update(down=fst["down"], on_replica_1=on_1,
                        fired=list(injector.fired_log))
        kv_after = kv_versions(light, ds)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    t_node = time.monotonic() - t0
    l_all, h_all = light.stats(), heavy.stats()
    # each deployment's own sync invariant (a spilling replica adds its
    # spill pulls), and every kernel launched at its per-tick count
    assert all(e.stats.host_syncs == e.stats.ticks + e.stats.spill_syncs
               for e in light.engines), [e.stats for e in light.engines]
    assert h_all["host_syncs"] == (h_all["decode_ticks"]
                                   + h_all["prefill_batches"]), h_all
    want = {"K1": l_all["ticks"] * lcfg.n_layers,
            "K2": n_attn * h_all["prefill_batches"],
            "K3": n_mamba * h_all["prefill_batches"],
            "K4": n_attn * h_all["decode_ticks"]}
    assert launches == want, (launches, want)
    assert all(n > 0 for n in launches.values()), launches
    for row in kv + kv_after:
        assert row["same_tensors"], row
    for row in kv + kv_after:
        assert row["latest_version"] == row["ticks"] + row["adoptions"], row
    assert ds.donate_misses == 0, ds.donate_misses
    assert len(arrivals) == sum(e.stats.graph_captures for e in engines) \
        == len(engines), arrivals
    # the light and escalated streams against engines outside the node
    t_ref = time.monotonic()
    light_ref = direct_streams(lcfg, lparams, dev, light_sent,
                               **LIGHT_ENGINE)
    heavy_ref = direct_streams(hcfg, hparams, dev, heavy_sent,
                               **HEAVY_ENGINE)
    t_ref = time.monotonic() - t_ref
    differ = {rid: first_difference(light.result(rid).tolist(), want)
              for rid, want in light_ref.items()
              if light.result(rid).tolist() != want}
    differ.update({f"heavy:{rid}": first_difference(
        heavy.result(rid).tolist(), want) for rid, want in heavy_ref.items()
        if heavy.result(rid).tolist() != want})
    assert not differ, differ
    # teardown: stop, drop the engines, and the memory they held
    pool_bytes = sum(e.cm.pool_bytes() for e in light.engines)
    del receipts, wave
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = allocated_outside_workspaces()
    light.stop()
    left = [k for k in ds.keys() if k.startswith("/kv/light")]
    assert not left, left
    light.engines.clear()
    del route, engines
    gc.collect()
    torch.cuda.empty_cache()
    fall_stop = before - allocated_outside_workspaces()
    lru_held = [k for k in (f"/kv/light/replica{r}/pool" for r in range(2))
                if k in ds.lru]
    lru_bytes = ds.lru.nbytes
    ds.lru = LRUCache(ds.lru.capacity_bytes)   # F9: the reference keeps it
    gc.collect()
    torch.cuda.empty_cache()
    fall = before - allocated_outside_workspaces()
    assert fall >= pool_bytes, (fall, pool_bytes)
    teardown = {"kv_keys_left": left, "pool_bytes": pool_bytes,
                "freed_after_stop_bytes": fall_stop,
                "read_cache_keys": lru_held, "read_cache_bytes": lru_bytes,
                "freed_after_read_cache_bytes": fall,
                "allocated_after_bytes": allocated_outside_workspaces()}
    res = {"phase": "cluster", "card": smi, "light": CLUSTER_LIGHT,
           "heavy": CLUSTER_HEAVY, "light_tier": ls, "heavy_tier": hs,
           "chat": {"sessions": chat, "prefix_hit_tokens": chat_hits},
           "cascade": {**cascade, "probe_logprobs": probe,
                       "escalated": sorted(rid for rid in prompts
                                           if rid in heavy_sent)},
           "kv": kv, "kv_after_failover": kv_after,
           "donate_hits": ds.donate_hits, "donate_misses": ds.donate_misses,
           "launches": launches, "launches_expected": want,
           "arrivals_during_captures": arrivals,
           "overload": overload, "failover": failover,
           "streams_equal_direct": {"light": len(light_ref),
                                    "heavy": len(heavy_ref)},
           "teardown": teardown, "main_s": t_main, "node_s": t_node,
           "reference_s": t_ref}
    node.close()
    del node, light, heavy, lparams, hparams, ds
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.monotonic() - t_phase
    emit(res)
    return res


def cluster_phase(dev, smi: str, serve_main: dict) -> dict:
    t0 = time.monotonic()
    single = cluster_single_tenant(dev, smi, serve_main)
    tenants = cluster_tenants(dev, smi)
    return {"single": single, "tenants": tenants,
            "seconds": time.monotonic() - t0}


# =================================================================== mesh
MESH_ARCH = "gemma2-9b"
# Each reduction of the model-2 tick, held against the exact (f64) sum of
# the shards' f32 parts: rounded once to bf16, it lies within half a bf16
# ulp of it (the f32 sum adds at most 2^-16 ulp).  A combine that rounds
# each part first strays further, and its control run must fail this.
# The first-tick logits cannot tell the two apart: against the same
# weights in f32 the control strays as far as bf16 itself (PERF.md)
MESH_COMBINE_ULPS = 0.5 + 2.0 ** -10
# K1 at the shard widths of the sharded serve: gemma2-9b's heads over model
# 2 and 4, and a shard's q heads over one kv head of a pool every shard
# replicates (n_kv_heads % model != 0): (label, H, pool K, kv-head slice)
MESH_K1_CASES = [("gemma2-9b model 2", 8, 4, None),
                 ("gemma2-9b model 4", 4, 2, None),
                 ("split q, replicated pool", 2, 4, (2, 3))]


@contextlib.contextmanager
def first_logits(out: list):
    """Inside the block, the logits of the first mixed step any engine runs
    (its first tick, eager) are cloned into ``out``, with clones of its
    inputs (block tables, tokens, positions, rows, sample lanes)."""
    import repro_torch.serving.engine as engine_mod

    inner = engine_mod.paged_mixed_step

    def spy(*a, **kw):
        logits = inner(*a, **kw)
        if not out:
            out.append((logits.clone(), [t.clone() for t in a[2:7]]))
        return logits

    engine_mod.paged_mixed_step = spy
    try:
        yield out
    finally:
        engine_mod.paged_mixed_step = inner


def mesh_serve(eng, reqs, label: str, smi: str, n_layers: int,
               drive=None) -> dict:
    """Serve ``reqs`` on ``eng`` (its K1 count set to 0 just before) under
    the sync check, with the bytes allocated outside the workspaces read
    after every tick: (the result line, streams, scores, first logits).
    ``drive`` submits and drains instead (a deployment's node)."""
    from repro_torch.kernels.decode_attention import ops

    done: dict = {}
    if drive is None:
        eng.on_complete = lambda r: done.setdefault(r.request_id, r)
    after_tick: list[int] = []
    tick = eng.tick

    def counted():
        n = tick()
        after_tick.append(allocated_outside_workspaces())
        return n

    eng.tick = counted
    logits: list = []
    torch.cuda.synchronize()
    ops.ragged_paged_attention.launches = 0
    t0 = time.monotonic()
    try:
        with first_logits(logits), syncs_forbidden(eng):
            if drive is None:
                for r in reqs:
                    eng.submit(r)
                eng.run_until_drained()
            else:
                done = drive(reqs)
    finally:
        del eng.tick
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.ragged_paged_attention.launches
    s = eng.stats
    assert len(done) == len(reqs) and all(r.error is None
                                          for r in done.values())
    assert s.host_syncs == s.ticks, (label, s.host_syncs, s.ticks)
    assert eng.cm.devstore.donate_misses == 0, label
    shards = 1 if eng.mesh is None else eng.mesh.size
    assert launches == s.ticks * n_layers * shards, (label, launches,
                                                     s.ticks)
    # no pool-sized allocation a tick: after the capture (tick 2) the bytes
    # allocated outside the workspaces stay put from tick to tick
    steady = after_tick[2:] or after_tick
    growth = max(steady) - min(steady)
    assert growth < eng.cm.pool_bytes() // n_layers, (label, growth)
    res = {"phase": "mesh_serve", "run": label, "card": smi,
           "shards": shards, "ticks": s.ticks, "host_syncs": s.host_syncs,
           "k1_launches": launches, "k1_per_tick": launches // s.ticks,
           **check_graphs(eng, s.ticks),
           "donate_misses": eng.cm.devstore.donate_misses,
           "donate_hits": eng.cm.devstore.donate_hits,
           "pool_bytes": eng.cm.pool_bytes(),
           "alloc_growth_after_capture_bytes": growth,
           "tpot_p50_s": statistics.median(s.tpot_s),
           "ttft_p50_s": statistics.median(s.ttft_s), "wall_s": wall}
    streams = {rid: list(r.tokens) for rid, r in done.items()}
    scores = {rid: list(r.scores) + list(r.entropies)
              for rid, r in done.items()}
    emit(res)
    return res, streams, scores, logits[0]


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value of ``x`` (8 significand bits)."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


@contextlib.contextmanager
def combine_checked(out: list, control: bool = False):
    """Inside the block, every split reduction of the layers
    (``models.slices.combine``) is held against the f64 sum of the shards'
    f32 parts: the largest distance, in bf16 ulps of that sum, is appended
    to ``out``.  ``control``: the combine is given each part rounded to
    the model's dtype first (the fault the check exists to catch).  A MoE
    half's shares (routed, shared: each summed and rounded alone, then
    added) are held one share at a time, each share's reduction run again
    alone for the check."""
    import repro_torch.models.slices as slices

    inner = slices.combine

    def ulps(parts, got) -> float:
        with torch.no_grad():
            exact = parts[0].double()
            for y in parts[1:]:
                exact = exact + y.to(exact.device).double()
            return max(((y.double() - exact.to(d)).abs()
                        / _bf16_ulp(exact.to(d))).max().item()
                       for d, y in got.items())

    def spy(ys, tp, split, dtype):
        if not split:
            return inner(ys, tp, split, dtype)
        rounded = lambda y: y.to(dtype).float()
        if isinstance(ys[0], list):
            fed = [[rounded(t) for t in y] for y in ys] if control else ys
            for j in range(len(ys[0])):
                with torch.no_grad():
                    alone = inner([y[j] for y in fed], tp, split, dtype)
                out.append(ulps([y[j] for y in ys], alone))
            return inner(fed, tp, split, dtype)
        fed = [rounded(y) for y in ys] if control else ys
        got = inner(fed, tp, split, dtype)
        out.append(ulps(ys, got))
        return got

    slices.combine = spy
    try:
        yield out
    finally:
        slices.combine = inner


def direct_first_tick(eng, inputs, control: bool) -> tuple:
    """The first tick's logits of the (sliced) engine ``eng``, run once
    eagerly on its fresh pool through ``paged_mixed_step`` with every
    split reduction checked (``combine_checked``): (logits, the largest
    distance of a reduction in ulps, the reductions checked)."""
    from repro_torch.models import paged_mixed_step

    ulps: list = []
    with combine_checked(ulps, control):
        logits = paged_mixed_step(eng._local_params, eng.cm.shard_pools,
                                  *inputs, eng.cfg, tp=eng._tp)
    torch.cuda.synchronize()
    return logits, max(ulps), len(ulps)


def f32_first_tick(cfg, params, inputs, dev) -> torch.Tensor:
    """The first tick's logits from the same weights upcast to f32 (one
    device, a fresh f32 pool): the exact function the bf16 paths round."""
    from repro_torch.models import init_paged_pools, paged_mixed_step
    from repro_torch.tree import tree_map

    bt, toks, pos, rows, sidx = inputs
    c32 = cfg.replace(dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    n_blocks = int(bt.max().item()) + 1
    pools = init_paged_pools(c32, n_blocks, LIGHT_BLOCK, device=dev)
    logits = paged_mixed_step(p32, pools, bt, toks, pos, rows, sidx, c32)
    torch.cuda.synchronize()
    return logits


def mesh_kernel_cases(dev, flush) -> list[dict]:
    """K1 at the sharded serve's local widths (``MESH_K1_CASES``; D 256,
    the serve's mixed T = 512 packing, softcap 50), bf16 and int8 pools,
    against its plain version; the replicated-pool case reads its kv head
    of the wider pool in place (``ops.pool_kv_stride``)."""
    from repro_torch.kernels.decode_attention import ops, quant, ref

    cases = []
    for label, h, kv, cut in MESH_K1_CASES:
        q32, k32, v32, bt, rows, pos, n_valid, bt_np, rows_np, pos_np = \
            kernel_inputs(dev, np.random.default_rng(5), h, kv)
        q = q32.to(torch.bfloat16)
        view = ((lambda t: t) if cut is None
                else (lambda t, c=cut: t[:, :, c[0]:c[1]]))
        local_kv = kv if cut is None else cut[1] - cut[0]
        for kv_dtype in ("bfloat16", "int8"):
            if kv_dtype == "bfloat16":
                kp, vp = k32.to(torch.bfloat16), v32.to(torch.bfloat16)
                ks = vs = None
            else:
                kp, ks = quant.quantize_kv(k32, kv_dtype)
                vp, vs = quant.quantize_kv(v32, kv_dtype)
            kp, vp = view(kp), view(vp)
            if ks is not None:
                ks, vs = view(ks), view(vs)
            assert ops.pool_kv_stride(kp) == kv
            kw = dict(k_scale=ks, v_scale=vs, window=None, softcap=50.0)
            if ks is None:
                plain = lambda q=q: ref.ragged_paged_attention_ref(
                    q, kp, vp, bt, rows, pos, softcap=50.0)
            else:
                plain = lambda q=q: ref.ragged_paged_attention_quant_ref(
                    q, kp, vp, ks, vs, bt, rows, pos, softcap=50.0)
            case, out = checked_case(
                lambda: ops.ragged_paged_attention(q, kp, vp, bt, rows, pos,
                                                   **kw),
                plain, 2e-2, *work(bt_np, rows_np, pos_np, None,
                                   kp.element_size(), 2, ks is not None, h,
                                   local_kv),
                torch.bfloat16, flush, (25, 5),
                plain32=lambda: plain(q.float()), kv_dtype=kv_dtype,
                q_dtype="bfloat16", shard=label, H=h, K=local_kv,
                pool_K=kv, kv_heads=cut, D=D, window=None, softcap=50.0,
                library_ms=None,
                **k1_spans(T, local_kv, h // local_kv, D, bt.shape[1]),
                **k1_route(q, kp, bt, rows, pos, None))
            assert bool((out[n_valid:] == 0).all()), "pad lanes not zero"
            if cut is not None:
                # in place: the same bits as the copied slice gives
                copied = ops.ragged_paged_attention(
                    q, kp.contiguous(), vp.contiguous(), bt, rows, pos,
                    **dict(kw, k_scale=None if ks is None
                           else ks.contiguous(),
                           v_scale=None if vs is None else vs.contiguous()))
                assert torch.equal(out, copied), "kv-head slice != copy"
            cases.append(case)
            emit({"phase": "mesh_kernel", **case})
    return cases


def mesh_spill_adopt(cfg, params, dev, smi: str) -> dict:
    """An int8 session spilled off a model-2 slice and adopted onto a
    one-device slice: the re-spilled blocks equal the first spill's bits;
    the continued stream beside the uninterrupted one-device stream."""
    from repro_torch.launch.mesh import logical_devices, mesh_slices
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.scheduler import Request

    prompt = serve_requests(cfg.vocab_size)[6].prompt       # 300 tokens
    kw = dict(n_slots=2, max_len=1024, token_budget=512, num_blocks=128,
              kv_dtype="int8", device=dev)
    with logical_devices(3, dev):
        mesh_a, mesh_b = mesh_slices(1, 2)[0], mesh_slices(3, 1)[2]
    ref = ServeEngine(cfg, params, mesh=mesh_b, **kw)
    want = Request(request_id="ref", session_key="s", prompt=prompt,
                   max_new_tokens=16)
    ref.submit(want)
    ref.run_until_drained()
    del ref
    eng_a = ServeEngine(cfg, params, mesh=mesh_a, **kw)
    eng_b = ServeEngine(cfg, params, mesh=mesh_b, **kw)
    req = Request(request_id="mig", session_key="s", prompt=prompt,
                  max_new_tokens=16)
    eng_a.submit(req)
    while len(req.tokens) < 3:
        eng_a.tick()
    slot = req.slot
    spilled = eng_a.spill(slot)
    eng_a.live.pop(slot)
    eng_a.cm.release(slot)
    assert eng_b.adopt(req, spilled)
    back = eng_b.spill(req.slot)
    leaves = [(a, b) for la, lb in zip(spilled.blocks, back.blocks)
              for a, b in zip(la.values(), lb.values())]
    assert all(a.dtype == b.dtype and torch.equal(
        a.view(torch.uint8), b.view(torch.uint8)) for a, b in leaves), \
        "int8 spill -> adopt -> spill changed a bit"
    eng_b.run_until_drained()
    for e in (eng_a, eng_b):
        assert e.stats.host_syncs == e.stats.ticks + e.stats.spill_syncs
        assert e.cm.devstore.donate_misses == 0
    assert list(req.tokens) == list(want.tokens), (
        "the adopted stream left the uninterrupted one",
        first_difference(list(req.tokens), list(want.tokens)))
    res = {"phase": "mesh_spill_adopt", "card": smi, "arch": cfg.name,
           "n_layers": cfg.n_layers, "dtype": cfg.dtype, "kv_dtype": "int8",
           "spilled_blocks": spilled.n_blocks, "leaves": len(leaves),
           "round_trip_bit_equal": True,
           "stream_equals_uninterrupted": list(req.tokens) ==
           list(want.tokens),
           "first_difference": first_difference(list(req.tokens),
                                                list(want.tokens))}
    del eng_a, eng_b
    emit(res)
    return res


def mesh_reshard(dev, smi: str) -> dict:
    """An AdamW train state of zamba2-2.7b cut to 6 layers (``reduced``:
    n_layers 54 -> 6) moved (1, 1) -> (1, 2) over two logical devices on
    the card -> (1, 1) by ``elastic_reshard``, every leaf bit-equal."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import logical_devices, make_host_mesh
    from repro_torch.models import param_axes, stacked_leaves
    from repro_torch.training.ft import elastic_reshard
    from repro_torch.training.optimizer import adamw
    from repro_torch.tree import named_leaves, tree_leaves

    cfg = get_config(TRAIN_ARCH).replace(n_layers=6)
    params = _seeded_params(cfg, dev, 0)
    opt = adamw().init(stacked_leaves(params, cfg))
    for t in tree_leaves(opt.mu) + tree_leaves(opt.nu):
        t.normal_()
    state = {"params": params, "opt": opt}
    axes = {"params": param_axes(cfg),
            "opt": S.opt_state_axes("adamw", param_axes(cfg), cfg)}
    with logical_devices(2, dev):
        meshes = [make_host_mesh(1, 1), make_host_mesh(2, 2),
                  make_host_mesh(1, 1)]
    t0 = time.monotonic()
    tree, split = state, 0
    for mesh in meshes:
        pls = S.tree_shardings(axes, mesh, S.make_rules(cfg, mesh))
        specs = {name: pl.spec for (name, _), pl in
                 zip(named_leaves(tree), tree_leaves(pls))}
        tree = elastic_reshard(tree, mesh, lambda path, leaf: specs[path])
        split = max(split, sum(t.placement.splits(t.ndim)
                               for t in tree_leaves(tree)))
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    pairs = list(zip(tree_leaves(tree), tree_leaves(state)))
    assert all(torch.equal(a.gather(dev).reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
               for a, b in pairs), "elastic_reshard changed a bit"
    res = {"phase": "mesh_reshard", "card": smi, "arch": cfg.name,
           "reduced": "n_layers 54 -> 6", "leaves": len(pairs),
           "split_leaves_on_1x2": split,
           "bytes": sum(b.numel() * b.element_size() for _, b in pairs),
           "bit_equal": True, "seconds": seconds}
    emit(res)
    return res


def mesh_phase(dev, smi: str) -> dict:
    """gemma2-9b at full width and depth, bf16, on the serve traffic and
    1,024 blocks: a one-device slice through a ``ServeNode`` deployment
    (``take_device_slices(1, 1)``), then a model-2 slice of two logical
    devices on the card, captured and eager; then full width cut to 4
    layers at f32 (greedy streams, an int8 spill across slices); K1 at the
    shard widths; ``elastic_reshard`` of a train state."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import logical_devices, mesh_slices
    from repro_torch.serving.cluster import ServeCluster
    from repro_torch.serving.engine import ServeEngine

    t0 = time.monotonic()
    cfg = get_config(MESH_ARCH)
    params = _seeded_params(cfg, dev, 0)
    reqs = lambda: serve_requests(cfg.vocab_size)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    kernel_cases = mesh_kernel_cases(dev, flush)
    del flush

    # 1. a one-device slice through a ServeNode deployment
    cluster = ServeCluster(cfg, params, n_replicas=1, device=dev,
                           devices_per_replica=1, **LIGHT_ENGINE)
    one = cluster.engines[0]
    assert one.mesh.devices.shape == (1, 1) and one._tp.devices == (dev,)
    assert not (one._tp.heads or one._tp.ffn or one._tp.vocab)
    assert cluster.node._free_devices == []

    def through_node(rs):
        receipts = [cluster.submit(r.session_key, r.request_id, r.prompt,
                                   max_new_tokens=r.max_new_tokens)
                    for r in rs]
        wait_all(receipts)
        node_drain(cluster.node, receipts)
        out = {}
        for r in rs:
            r.tokens = cluster.result(r.request_id).tolist()
            out[r.request_id] = r
        return out

    single, single_streams, _, (single_logits, single_in) = mesh_serve(
        one, reqs(), "one-device slice (ServeNode deployment)", smi,
        cfg.n_layers, drive=through_node)
    cluster.close()
    del cluster, one
    gc.collect()
    torch.cuda.empty_cache()

    # 2. a model-2 slice of two logical devices on the card
    with logical_devices(2, dev):
        [mesh] = mesh_slices(1, 2)
    runs = {}
    for graphs in (True, False):
        eng = ServeEngine(cfg, params, device=dev, mesh=mesh,
                          cuda_graphs=graphs, **LIGHT_ENGINE)
        local = eng._local_params[0]["layers"][0]["attn"]
        pool = eng.cm.shard_pools[0][0]["k"]
        # gemma2-9b's 16 q and 8 kv heads split over the two shards: K1
        # runs at local H = 8, K = 4, D = 256
        assert (local["wq"].shape[1], pool.shape[2], pool.shape[3]) == (
            cfg.n_heads // 2, cfg.n_kv_heads // 2, cfg.head_dim)
        assert eng._tp.kv_heads == (None, None) and eng._tp.heads
        kind = "captured" if graphs else "eager"
        runs[graphs] = mesh_serve(eng, reqs(), f"model-2 slice, {kind}",
                                  smi, cfg.n_layers)
        del eng, local, pool
        gc.collect()
        torch.cuda.empty_cache()
    (cap, cap_streams, cap_scores, (cap_logits, cap_in)), \
        (eag, eag_streams, eag_scores, _) = runs[True], runs[False]
    assert cap["k1_per_tick"] == 2 * cfg.n_layers       # 84: 42 x 2
    assert cap_streams == eag_streams and cap_scores == eag_scores, \
        "model-2 captured tick != eager tick"
    assert all(torch.equal(a, b) for a, b in zip(cap_in, single_in))
    assert cap_logits.shape == single_logits.shape
    # the model-2 first tick again, run directly with every reduction
    # checked, and its control: a combine that rounds each shard's part
    eng = ServeEngine(cfg, params, device=dev, mesh=mesh, cuda_graphs=False,
                      **LIGHT_ENGINE)
    direct, ulps, reductions = direct_first_tick(eng, cap_in, False)
    ctl_logits, ctl_ulps, _ = direct_first_tick(eng, cap_in, True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # bf16 at full depth: the shards' products round at other points than
    # the one device's, and 42 layers carry each rounding on, so the two
    # are measured against the same weights in f32 (reported)
    ref = f32_first_tick(cfg, params, single_in, dev)
    dist = lambda x: ((x - ref).abs().max().item(),
                      (x - ref).abs().mean().item())
    (err_one, mean_one), (err_two, mean_two), (err_ctl, mean_ctl) = (
        dist(single_logits), dist(cap_logits), dist(ctl_logits))
    del ref
    err = (cap_logits - single_logits).abs().max().item()
    scale = single_logits.abs().max().item()
    argmax_equal = bool(torch.equal(cap_logits.argmax(-1),
                                    single_logits.argmax(-1)))
    same = {rid: first_difference(cap_streams[rid], single_streams[rid])
            for rid in cap_streams}
    matched = sum(len(cap_streams[rid]) if d is None else d
                  for rid, d in same.items())
    readings = {"phase": "mesh_logits", "card": smi, "arch": cfg.name,
                "first_tick_logits_max_abs_err": err, "logit_scale": scale,
                "f32_ref_max_err": {"one_device": err_one,
                                    "model2": err_two, "control": err_ctl},
                "f32_ref_mean_err": {"one_device": mean_one,
                                     "model2": mean_two,
                                     "control": mean_ctl},
                "f32_ratio": {"model2": err_two / err_one,
                              "control": err_ctl / err_one},
                "reductions_checked": reductions,
                "reduction_max_ulps": {"model2": ulps, "control": ctl_ulps},
                "reduction_bound_ulps": MESH_COMBINE_ULPS,
                "direct_equals_engine": bool(torch.equal(direct,
                                                         cap_logits)),
                "first_tick_argmax_equal": argmax_equal,
                "greedy_tokens_matching_one_device": matched}
    emit(readings)
    del direct, ctl_logits
    assert readings["direct_equals_engine"], "direct first tick != engine's"
    assert reductions == 2 * cfg.n_layers, reductions
    assert ulps <= MESH_COMBINE_ULPS < ctl_ulps, (ulps, ctl_ulps)
    assert argmax_equal, "model-2 first-tick argmax != one device's"
    del params, runs
    gc.collect()
    torch.cuda.empty_cache()

    # 3. full width cut to 4 layers, f32: streams equal; int8 spill/adopt
    f32 = cfg.replace(n_layers=4, dtype="float32")
    params = _seeded_params(f32, dev, 0)
    streams = {}
    for label, m in (("f32 one device", None), ("f32 model-2", mesh)):
        eng = ServeEngine(f32, params, device=dev, mesh=m, **LIGHT_ENGINE)
        streams[label] = mesh_serve(eng, reqs(), label, smi, f32.n_layers)[1]
        del eng
    assert streams["f32 model-2"] == streams["f32 one device"], \
        "f32 model-2 streams != one-device streams"
    spill = mesh_spill_adopt(f32, params, dev, smi)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    reshard = mesh_reshard(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    res = {"phase": "mesh", "card": smi, "arch": cfg.name,
           "first_tick_logits_max_abs_err": err, "logit_scale": scale,
           "f32_ratio": readings["f32_ratio"],
           "reduction_max_ulps": readings["reduction_max_ulps"],
           "first_tick_argmax_equal": argmax_equal,
           "captured_equals_eager": True,
           "greedy_tokens_matching_one_device": matched,
           "greedy_tokens": sum(len(v) for v in cap_streams.values()),
           "first_difference_by_request": same,
           "tpot_p50_s": {"one_device": single["tpot_p50_s"],
                          "model2_captured": cap["tpot_p50_s"],
                          "model2_eager": eag["tpot_p50_s"]},
           "k1_launches": cap["k1_launches"], "ticks": cap["ticks"],
           "f32_streams_equal": True, "spill_adopt": spill,
           "reshard": reshard, "kernel_cases": kernel_cases,
           "seconds": time.monotonic() - t0}
    emit({k: v for k, v in res.items() if k not in ("spill_adopt",
                                                    "reshard",
                                                    "kernel_cases")})
    return res


# ==================================================================== MoE
# the MoE layer's routing and dispatch kernels in a trace, by name: scatter_
# and gather, index / index_put_, cumsum's scan, topk's select and sort.
# Approximate: the embedding lookup's index kernel lands here too, and
# softmax, where and the zero fills count as other
MOE_DISPATCH = ("scatter", "gather", "index", "scan", "topk", "sort",
                "radix")


class RepeatDrafts:
    """Proposes the row's last token k times (a duck-typed DraftSource):
    drafts that are mostly rejected, so the verify rows and their rollback
    run whatever the weights generate."""

    def propose(self, req, history, k):
        return [int(history()[-1])] * k


def moe_drop_shares(cfg, params, dev) -> dict:
    """The share of (token, slot) entries that capacity drops at each MoE
    layer of one served tick: the serve traffic's first tick, run eagerly,
    each layer's hidden states routed again by the port's dispatch plan
    (``models/moe.py::dispatch_plan``).  Over all lanes, and over the lanes
    that hold a token (pad lanes share one hidden state, so they choose the
    same experts, and they pack after the tokens)."""
    import importlib

    from repro_torch.models import lm
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.engine import ServeEngine

    moe_mod = importlib.import_module("repro_torch.models.moe")
    eng = ServeEngine(cfg, params, n_slots=8, token_budget=512, max_len=8192,
                      num_blocks=1024, device=dev, cuda_graphs=False)
    for r in serve_requests(cfg.vocab_size):
        eng.submit(r)
    lanes, dropped = [], []
    step, layer = engine_mod.paged_mixed_step, lm.moe

    def spy_step(params, pools, bt, tokens, positions, *a, **kw):
        lanes.append(positions >= 0)
        return step(params, pools, bt, tokens, positions, *a, **kw)

    def spy_moe(p, x, *, cfg):
        plan = moe_mod.dispatch_plan(p, x.reshape(-1, x.shape[-1]), cfg)
        dropped.append(~plan.keep)
        return layer(p, x, cfg=cfg)

    engine_mod.paged_mixed_step, lm.moe = spy_step, spy_moe
    try:
        eng.tick()
    finally:
        engine_mod.paged_mixed_step, lm.moe = step, layer
    del eng
    token = lanes[0]
    every = [float(d.float().mean()) for d in dropped]
    tokens = [float(d[token].float().mean()) for d in dropped]
    return {"tick": 1, "lanes": token.numel(), "token_lanes": int(token.sum()),
            "moe_layers": len(dropped),
            "dropped_share_mean": statistics.fmean(every),
            "dropped_share_max": max(every),
            "dropped_share_token_lanes_mean": statistics.fmean(tokens),
            "dropped_share_token_lanes_max": max(tokens)}


def serve_moe_phase(dev, smi: str) -> dict:
    """``ServeEngine`` serving deepseek-moe-16b at full width and depth (28
    layers, 27 of them MoE: 64 routed experts top-6 and 2 shared; bf16,
    seeded weights) on the serve traffic: captured, eagerly, captured
    again (the three streams equal), at spec_k=2 with ``RepeatDrafts``
    (the n-gram drafter finds nothing to propose on these weights; its
    streams reported against spec_k=0's, not asserted: capacity makes a
    token's output depend on the other tokens of its tick), then one
    captured run traced; and one tick's capacity drops."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("deepseek-moe-16b")
    t0 = time.monotonic()
    params = _seeded_params(cfg, dev, 0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    assert n_params == cfg.param_count(), (n_params, cfg.param_count())
    emit({"phase": "init", "arch": cfg.name, "params": n_params,
          "param_bytes": sum(t.numel() * t.element_size()
                             for t in _leaves(params)),
          "seconds": time.monotonic() - t0})
    drops = moe_drop_shares(cfg, params, dev)
    main, greedy = serve_once(cfg, params, dev, smi)
    eager, eager_streams = serve_once(cfg, params, dev, smi,
                                      cuda_graphs=False)
    assert eager_streams == greedy, "MoE: captured and eager streams differ"
    again, again_streams = serve_once(cfg, params, dev, smi)
    assert again_streams == greedy, "MoE: a second captured run differs"
    spec, spec_streams = serve_once(cfg, params, dev, smi, spec_k=2,
                                    draft_source=RepeatDrafts())
    assert spec["spec_drafted"] > 0
    for res in (main, eager, again, spec):
        # K1 at every layer of every tick
        assert res["k1_launches"] == res["ticks"] * cfg.n_layers, res
    traced = trace_phase(cfg, params, dev, True,
                         {"K1": K1_KERNELS, "gemm": GEMM_KEYS,
                          "moe_dispatch": MOE_DISPATCH})
    graphs_line("paged deepseek-moe-16b bf16 spec_k=0", smi, main,
                dict(again, **traced),
                dict(eager, device_idle_share="not measured"))
    res = {"phase": "serve_moe", "arch": cfg.name, "card": smi,
           "params": n_params, "ticks": main["ticks"],
           "host_syncs": main["host_syncs"],
           "k1_launches": main["k1_launches"],
           "captured_equals_eager": True, "second_capture_equal": True,
           "spec_k2_drafted": spec["spec_drafted"],
           "spec_k2_accepted": spec["spec_accepted"],
           "spec_k2_streams_equal": spec_streams == greedy,
           "spec_k2_streams_differing": sum(
               spec_streams[k] != greedy[k] for k in greedy),
           **{m: again[m] for m in GRAPH_METRICS if m in again},
           "first_run": {m: main[m] for m in GRAPH_METRICS if m in main},
           "pool_bytes": main["pool_bytes"], "drops": drops,
           "moe_dispatch_group": "approximate (see MOE_DISPATCH)",
           "trace_group_ms": traced["group_ms"]}
    emit(res)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def moe_check_phase(dev, smi: str, S=2048) -> dict:
    """llama4-maverick-400b-a17b at full width cut to one period of its
    pattern (n_layers 48 -> 2: a dense layer, then a MoE layer of 128
    experts top-1 and one shared; bf16, seeded weights): ``forward`` over
    S tokens with K2 against the same forward with the plain attention,
    then a three-request paged serve captured and eagerly.

    K2 and its plain version round differently, so a token whose router
    probabilities nearly tie may choose another expert in the two runs (and
    move a later token of those experts past the capacity).  The logits of
    every token that both runs send to the same expert, or drop alike, are
    held within 2e-2 of the logits' scale; the share of such tokens must be
    at least 0.9."""
    import importlib

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import attention, forward, lm

    moe_mod = importlib.import_module("repro_torch.models.moe")
    cfg = get_config("llama4-maverick-400b-a17b").replace(n_layers=2)
    t0 = time.monotonic()
    params = _seeded_params(cfg, dev, 7)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    assert n_params == cfg.param_count(), (n_params, cfg.param_count())
    init_s = time.monotonic() - t0
    toks, pos = _prompt(cfg.vocab_size, S, 7, dev)
    kernel_fn, layer = attention.fa_ops.flash_attention, lm.moe

    def plain_fn(q, k, v, *, positions=None, **kw):
        return fa_ref.attention_ref(q, k, v, **kw)

    runs = {}
    for name, fn in (("kernel", kernel_fn), ("plain", plain_fn)):
        routes = []

        def spy(p, x, *, cfg):
            plan = moe_mod.dispatch_plan(p, x.reshape(-1, x.shape[-1]), cfg)
            # each entry's expert, or -1 where capacity dropped it
            routes.append(torch.where(
                plan.keep, plan.row // (plan.groups * plan.capacity), -1))
            return layer(p, x, cfg=cfg)

        attention.fa_ops.flash_attention, lm.moe = fn, spy
        kernel_fn.launches = 0
        try:
            logits, aux = forward(params, toks, pos, cfg)
        finally:
            attention.fa_ops.flash_attention, lm.moe = kernel_fn, layer
        runs[name] = (logits, float(aux), routes, kernel_fn.launches)
    (a, aux_a, ra, k2), (b, aux_b, rb, _) = runs.pop("kernel"), \
        runs.pop("plain")
    assert k2 == 2, k2
    assert a.shape == (1, S, cfg.vocab_size) and a.dtype == torch.float32
    assert bool(torch.isfinite(a).all())
    assert math.isfinite(aux_a) and aux_a >= 1 - 1e-3, aux_a
    same = torch.stack([(x == y).all(-1) for x, y in zip(ra, rb)]).all(0)
    same_share = float(same.float().mean())
    err = (a[0, same] - b[0, same]).abs().max().item()
    scale = b.abs().max().item()
    assert same_share >= 0.9, same_share
    assert err <= 2e-2 * scale, (err, scale)
    res = {"phase": "moe_check", "arch": cfg.name, "card": smi,
           "reduced": "n_layers 48 -> 2", "params": n_params,
           "init_s": init_s, "tokens": S, "k2_launches": k2,
           "aux_kernel": aux_a, "aux_plain": aux_b,
           "routed_alike_share": same_share,
           "kernel_vs_plain_max_abs_err_routed_alike": err,
           "logit_scale": scale,
           "argmax_equal_share": float((a.argmax(-1) == b.argmax(-1)).float()
                                       .mean())}
    del a, b, ra, rb
    served = {}
    for graphs in (True, False):
        r, streams = serve_once(cfg, params, dev, smi,
                                reqs=serve_requests(cfg.vocab_size)[1:4],
                                cuda_graphs=graphs)
        assert r["k1_launches"] == r["ticks"] * cfg.n_layers, r
        served[graphs] = streams
        res["serve_captured" if graphs else "serve_eager"] = {
            k: r[k] for k in ("ticks", "host_syncs", "k1_launches",
                              "ttft_p50_s", "tpot_p50_s", "tokens_per_s",
                              "peak_mem_bytes")}
    assert served[True] == served[False], "llama4: captured != eager"
    res["captured_equals_eager"] = True
    emit(res)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ================================================================= embeds
# the embeds configs: a frontend (musicgen's EnCodec, phi-3-vision's CLIP
# tower; stubbed, as in the reference) hands (B, S, d) activations to the
# decoder, which takes them as they are
EMBEDS_ARCHS = ("musicgen-large", "phi-3-vision-4.2b")
EMBEDS_SCORE_S = 8192
# the node's engine: 4 slots x 4608 positions of musicgen-large's 48 layers
# (7.25 GB of cache) fit beside the weights, and 4608 holds the traffic's
# longest prompt (4500)
NODE_EMBEDS = dict(n_slots=4, max_len=4608, paged=False)
F12_NEW_TOKENS = 4


def _embeddings(shape, seed, dev):
    """Seeded N(0, 1) frontend embeddings, f32, made on the card (the
    reference's synthetic embeds batches are N(0, 1) f32)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev)


def embeds_requests(d: int, new: int = 1):
    """The dense serve's prompt lengths (four of 2048, one batched prefill;
    then 4500, 17, 300 and 1000) as (S, d) f32 N(0, 1) embeddings, made
    with numpy in bulk; ``new`` tokens each."""
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(13)
    flat = rng.standard_normal((sum(DENSE_PROMPTS), d), dtype=np.float32)
    cuts = np.cumsum(DENSE_PROMPTS)[:-1]
    return [Request(request_id=f"e{i}", session_key=f"e{i}", prompt=p,
                    max_new_tokens=new)
            for i, p in enumerate(np.split(flat, cuts))]


def score_embeds(cfg, params, dev, smi: str, S=EMBEDS_SCORE_S) -> dict:
    """``forward`` over B = 1, S embeddings at full width and depth: a first
    forward checks the output, a second is timed and launches K2 once per
    layer (and no other kernel of the port)."""
    from repro_torch.models import forward

    x = _embeddings((1, S, cfg.d_model), 11, dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
    logits, aux = forward(params, x, pos, cfg)
    assert logits.shape == (1, S, cfg.vocab_size), logits.shape
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    assert bool(torch.isfinite(logits).all()), cfg.name
    del logits
    counters = _kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.monotonic()
    logits, _ = forward(params, x, pos, cfg)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    assert launches == {"K2": cfg.n_layers, "K3": 0, "K4": 0}, launches
    assert bool(torch.isfinite(logits).all()), cfg.name
    res = {"phase": "score_embeds", "arch": cfg.name, "card": smi,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "head_dim": cfg.head_dim, "B": 1, "S": S, "dtype": cfg.dtype,
           "k2_launches": launches["K2"], "wall_s": wall,
           "tokens_per_s": S / wall,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    del logits, x
    emit(res)
    return res


def embeds_check(cfg, params, dev, smi: str, S=1000, steps=32, B=8,
                 max_len=8192) -> dict:
    """``prefill`` of S embeddings over B slots of ``max_len``, then
    ``steps`` ``decode_step``s on further (B, 1, d) embeddings (K4 over the
    dense caches); the last step's logits against ``forward`` over all
    S + steps embeddings (K2), within 2e-2 of the logits' scale (bf16
    activations: one rounding of an attention output carried through the
    layers, as ``ssm_check`` holds them), and the prefill's logits against
    ``forward``'s at position S - 1."""
    from repro_torch.models import decode_step, forward, prefill

    x = _embeddings((B, S + steps, cfg.d_model), 12, dev)
    pos = torch.arange(S + steps, dtype=torch.int32, device=dev).repeat(B, 1)
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    first, caches = prefill(params, x[:, :S], pos[:, :S], cfg,
                            max_len=max_len)
    k2 = counters["K2"].launches
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for t in range(S, S + steps):
        stepped, _ = decode_step(params, caches, x[:, t:t + 1],
                                 pos[:, t:t + 1], cfg)
    torch.cuda.synchronize()
    step_s = (time.monotonic() - t0) / steps
    launches = {k: fn.launches for k, fn in counters.items()}
    assert k2 == cfg.n_layers, k2
    assert launches == {"K2": cfg.n_layers, "K3": 0,
                        "K4": cfg.n_layers * steps}, launches
    cache_bytes = sum(t.numel() * t.element_size() for c in caches
                      for t in c.values())
    del caches
    whole = forward(params, x, pos, cfg)[0]
    res = {"phase": "embeds_check", "arch": cfg.name, "card": smi, "B": B,
           "prefill": S, "decode_steps": steps, "max_len": max_len,
           "cache_bytes": cache_bytes, "decode_step_s": step_s,
           "launches": launches}
    for name, got, want in (("prefill", first, whole[:, S - 1]),
                            ("last_step", stepped, whole[:, -1])):
        assert bool(torch.isfinite(got).all()), (cfg.name, name)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        assert err <= 2e-2 * scale, (cfg.name, name, err, scale)
        res[name] = {"max_abs_err": err, "logit_scale": scale,
                     "argmax_equal_rows": int((got.argmax(-1)
                                               == want.argmax(-1)).sum())}
    del whole, x
    emit(res)
    return res


def direct_first_tokens(cfg, params, reqs, dev, max_len: int) -> dict:
    """The argmax of a direct ``prefill`` of each request's prompt, the
    prompts grouped as one admission of the dense engine groups them
    (contiguous runs of equal length, one batched prefill each)."""
    from repro_torch.models import prefill

    out, i = {}, 0
    while i < len(reqs):
        j = i
        while j < len(reqs) and reqs[j].prompt.shape == reqs[i].prompt.shape:
            j += 1
        group = reqs[i:j]
        S = group[0].prompt.shape[0]
        x = torch.from_numpy(np.stack([r.prompt for r in group])).to(dev)
        pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(j - i, 1)
        logits, caches = prefill(params, x, pos, cfg, max_len=max_len)
        for r, tok in zip(group, logits.argmax(-1).tolist()):
            out[r.request_id] = [tok]
        del logits, caches, x
        i = j
    torch.cuda.empty_cache()
    return out


def serve_embeds(cfg, params, dev, smi: str) -> dict:
    """The dense ``ServeEngine`` (8 slots of 8192) on the embeds traffic,
    one greedy token each: every first token equals the argmax of a direct
    prefill grouped alike; host_syncs == prefill_batches (no decode tick);
    K2 == n_layers x prefill_batches; then a request for
    ``F12_NEW_TOKENS`` tokens is rejected naming F12 and the engine stays
    idle."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.scheduler import Request, Scheduler

    reqs = embeds_requests(cfg.d_model)
    want = direct_first_tokens(cfg, params, reqs, dev, 8192)
    base = allocated_outside_workspaces()
    eng = ServeEngine(cfg, params, n_slots=8, max_len=8192,
                      scheduler=Scheduler(prefill_budget=8), device=dev)
    assert not eng.paged
    done = []
    eng.on_complete = done.append
    counters = _kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.monotonic()
    with syncs_forbidden(eng):
        for r in reqs:
            r.arrived_s = time.monotonic()     # made before the direct runs
            eng.submit(r)
        eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    s = eng.stats
    got = {r.request_id: list(r.tokens) for r in done}
    assert len(done) == len(reqs) and all(r.error is None for r in done)
    assert got == want, {rid: (got[rid], want[rid]) for rid in got
                         if got[rid] != want[rid]}
    assert s.prefill_batches == 5 and s.decode_ticks == 0, s
    assert s.host_syncs == s.prefill_batches, s
    assert launches == {"K2": cfg.n_layers * s.prefill_batches, "K3": 0,
                        "K4": 0}, launches
    assert all(np.isfinite(r.scores).all() for r in done)
    res = {"phase": "serve_embeds", "arch": cfg.name, "card": smi,
           "n_layers": cfg.n_layers, "n_slots": 8, "max_len": 8192,
           "prompts": list(DENSE_PROMPTS), "prefill_batches":
           s.prefill_batches, "host_syncs": s.host_syncs,
           "launches": launches, "first_tokens_equal_direct_prefill": True,
           "wall_s": wall, "ttft_p50_s": statistics.median(s.ttft_s),
           "ttft_p99_s": float(np.percentile(s.ttft_s, 99)),
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    f12 = Request(request_id="f12", session_key="f12",
                  prompt=reqs[5].prompt, max_new_tokens=F12_NEW_TOKENS)
    ticks = s.ticks
    eng.submit(f12)
    assert done[-1] is f12 and "F12" in str(f12.error), f12.error
    assert f12.tokens == [] and eng.idle() and eng.stats.ticks == ticks
    res["f12_rejected"] = f12.error
    ref = graph_ref(eng)
    del eng, done
    res["kept_after_delete_bytes"] = check_dropped(ref, base)
    res["tokens"] = got
    emit(res)
    return res


def serve_embeds_node(cfg, params, dev, smi: str, engine_tokens: dict
                      ) -> dict:
    """``ServeCluster(musicgen-large, n_replicas=1)`` on the same traffic:
    each (S, d) f32 prompt crosses the node's host store; the answers equal
    a direct engine's of the same shape (``NODE_EMBEDS``, the same
    admission), host_syncs == prefill_batches, K2 == n_layers x
    prefill_batches, and a multi-token request comes back with the F12
    error; the queue wait from client submit to issue is reported."""
    from repro_torch.serving.cluster import ServeCluster

    reqs = embeds_requests(cfg.d_model)
    cluster = ServeCluster(cfg, params, n_replicas=1, device=dev,
                           **NODE_EMBEDS)
    eng = cluster.engines[0]
    counters = _kernel_counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.monotonic()
    with syncs_forbidden(eng):
        receipts = [cluster.submit(r.session_key, r.request_id, r.prompt,
                                   max_new_tokens=1) for r in reqs]
        wait_all(receipts)             # one queue, as the direct engine had
        node_drain(cluster.node, receipts)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    st = cluster.stats()
    answers = {r.request_id: cluster.result(r.request_id).tolist()
               for r in reqs}
    waits = sorted(w for ws in eng.stats.queue_wait_s.values() for w in ws)
    cluster.submit("f12", "f12", reqs[5].prompt,
                   max_new_tokens=F12_NEW_TOKENS).wait()
    node_drain(cluster.node)
    f12 = cluster.error("f12")
    assert "F12" in str(f12), f12
    assert cluster.result("f12").size == 0         # refused: no token
    res = {"phase": "serve_embeds_node", "arch": cfg.name, "card": smi,
           **NODE_EMBEDS, "ticks": st["ticks"],
           "prefill_batches": st["prefill_batches"],
           "host_syncs": st["host_syncs"], "launches": launches,
           "largest_prompt_bytes": max(r.prompt.nbytes for r in reqs),
           "wall_s": wall, "queue_wait_p50_s": statistics.median(waits),
           "ttft_p50_s": st["ttft_p50_s"], "f12_error": str(f12),
           "equal_to_serve_embeds": answers == engine_tokens}
    cluster.close()
    del cluster, eng, receipts
    gc.collect()
    torch.cuda.empty_cache()
    assert st["host_syncs"] == st["prefill_batches"] + st["decode_ticks"]
    assert st["decode_ticks"] == 0, st
    assert launches == {"K2": cfg.n_layers * st["prefill_batches"],
                        "K3": 0, "K4": 0}, launches
    direct = direct_streams(cfg, params, dev,
                            {r.request_id: (r.prompt, 1) for r in reqs},
                            **NODE_EMBEDS)
    assert answers == direct, {rid: (answers[rid], direct[rid])
                               for rid in answers
                               if answers[rid] != direct[rid]}
    res["equal_to_direct_engine"] = True
    emit(res)
    return res


# fastpath (1): three light stages on one phi-3-vision prompt's activations
FASTPATH_SHAPE = (1, 2048, 3072)
FASTPATH_RUNS = 200


def _light_stages():
    from repro_torch.core.fastpath import Stage

    return [Stage("scale", lambda x: x * 2.0),
            Stage("shift", lambda x: x + 1.0),
            Stage("squash", torch.tanh)]


def _brokered(stages):
    """The chain with a ``broker_hop`` at each stage boundary."""
    from repro_torch.core.fastpath import broker_hop

    def run(x):
        for i, st in enumerate(stages):
            x = st.fn(broker_hop(x) if i else x)
        return x
    return run


def _synced_ms(fn, *args) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _pct(xs, q) -> float:
    return float(np.percentile(xs, q))


def _profiled_calls(fn, x, n: int):
    """n calls of ``fn(x)`` under torch.profiler: the CUDA runtime calls by
    name, and the device time by group with the idle share."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            fn(x)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    calls = Counter(ev.name for ev in prof.events()
                    if ev.name.startswith("cu"))
    return calls, _device_time(prof, wall, {"memcpy": ("memcpy",)})


def fastpath_single_dispatch(fused, chained, x, n=10) -> dict:
    """After its first call, one call of the fused rung is one CUDA graph
    launch: under ``torch.profiler`` n calls make n graph launches, no
    kernel launch outside the graph, and the copies in and out; the
    replay counter moves by n.  The chained rung's n calls beside it, for
    where each rung's time goes on the device."""
    replays = fused.replays
    calls, device = _profiled_calls(fused, x, n)
    graph = sum(c for k, c in calls.items() if "GraphLaunch" in k)
    kernel = sum(c for k, c in calls.items() if "LaunchKernel" in k)
    res = {"calls": n, "replays": fused.replays - replays,
           "graph_launches": graph, "kernel_launches_outside_graph": kernel,
           "runtime_calls": dict(calls), "fused_device": device}
    assert res["replays"] == n and graph == n and kernel == 0, res
    calls, device = _profiled_calls(chained, x, n)
    res["chained_runtime_calls"] = dict(calls)
    res["chained_device"] = device
    return res


def fastpath_donation(dev) -> dict:
    """On the card: a donated group's graph reads the first input it was
    given (no buffer of its own), later inputs are copied into it; an
    undonated group keeps its own buffer and the caller's input
    unchanged."""
    from repro_torch.core.fastpath import fuse_stages

    x = _embeddings(FASTPATH_SHAPE, 16, dev).to(torch.bfloat16)
    y = _embeddings(FASTPATH_SHAPE, 17, dev).to(torch.bfloat16)
    want_y = torch.tanh(y * 2.0 + 1.0)
    kept = fuse_stages(_light_stages(), donate=False)
    x0 = x.clone()
    kept(x)
    (cap,) = kept._graphs.values()
    assert cap.inputs[0] is not x and torch.equal(x, x0)
    assert torch.equal(kept(y), want_y) and torch.equal(x, x0)
    donated = fuse_stages(_light_stages(), donate=True)
    before = torch.cuda.memory_allocated()
    donated(x)
    (cap,) = donated._graphs.values()
    assert cap.inputs[0] is x
    alloc = torch.cuda.memory_allocated() - before
    # the documented cost of donation: the tensor first donated is the
    # graph's input buffer, so it now holds the later call's input
    assert torch.equal(donated(y), want_y) and torch.equal(x, y)
    return {"undonated_input_untouched": True,
            "donated_input_is_graph_buffer": True,
            "donated_input_overwritten_by_later_call": True,
            "donated_first_call_alloc_bytes": alloc}


def fastpath_capture_cache(dev) -> dict:
    """A fused group keeps at most ``max_graphs`` captures.  Three input
    shapes of one size through a group that keeps two: the third capture
    evicts the first, so the memory the group holds (allocated, and
    reserved after emptying the cache) stays that of two captures; the
    evicted shape is captured again and still gives the right output."""
    from repro_torch.core.fastpath import fuse_stages

    shapes = [(1, 2048, 3072), (2, 1024, 3072), (4, 512, 3072)]
    xs = [_embeddings(sh, 20 + i, dev).to(torch.bfloat16)
          for i, sh in enumerate(shapes)]
    fused = fuse_stages(_light_stages(), donate=False, max_graphs=2)
    alloc, reserved = [], []
    for x in xs:
        fused(x)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        alloc.append(torch.cuda.memory_allocated())
        reserved.append(torch.cuda.memory_reserved())
    assert (fused.captures, fused.evictions) == (3, 1), fused.__dict__
    assert [k[0][1] for k in fused._graphs] == shapes[1:]
    assert alloc[2] <= alloc[1], alloc      # the first capture's buffers went
    assert torch.equal(fused(xs[0]), torch.tanh(xs[0] * 2.0 + 1.0))
    assert (fused.captures, fused.evictions) == (4, 2)
    return {"max_graphs": 2, "shapes": [list(sh) for sh in shapes],
            "allocated_bytes_after_each": alloc,
            "reserved_bytes_after_each": reserved,
            "captures": fused.captures, "evictions": fused.evictions}


def fastpath_phase(cfg, params, dev, smi: str) -> dict:
    """The device fast path's rungs on the card.  (1) Three light stages on
    a (1, 2048, 3072) bf16 activation (one phi-3-vision prompt, 12.6 MB),
    fused (one CUDA graph), chained and with a ``broker_hop`` at each of the
    two boundaries, ``FASTPATH_RUNS`` runs each in turns (host clock around
    a synchronized run): bit-equal outputs, each rung's p50 / p99 a run,
    the hop timed alone and what the brokered run adds to the chained one
    per hop, the single-dispatch check, the donation contract and the
    bounded capture cache.  (2) A frontend (a projection of (1, 2048,
    1024) patch features to d = 3072) into phi-3-vision's ``forward`` at
    full depth, chained, with the broker hop between the two, and fused
    (the whole pipeline, backbone included, one CUDA graph): bit-equal
    logits, each rung's end-to-end time and the hop's share of the
    brokered run."""
    from repro_torch.core.fastpath import (Stage, broker_hop, chain_stages,
                                           fuse_stages)
    from repro_torch.models import forward

    stages = _light_stages()
    x = _embeddings(FASTPATH_SHAPE, 15, dev).to(torch.bfloat16)
    rungs = {"fused": fuse_stages(stages, donate=False),
             "chained": chain_stages(stages), "broker": _brokered(stages)}
    outs = {name: fn(x) for name, fn in rungs.items()}
    outs["fused_replay"] = rungs["fused"](x)
    assert all(torch.equal(o, outs["chained"]) for o in outs.values()), \
        "the rungs' outputs differ"
    times = {name: [] for name in rungs}
    for _ in range(FASTPATH_RUNS):
        for name, fn in rungs.items():
            times[name].append(_synced_ms(fn, x))
    hop = [_synced_ms(broker_hop, x) for _ in range(FASTPATH_RUNS)]
    light = {name: {"run_ms_p50": _pct(t, 50), "run_ms_p99": _pct(t, 99)}
             for name, t in times.items()}
    res = {"phase": "fastpath", "card": smi, "shape": list(FASTPATH_SHAPE),
           "dtype": "bfloat16", "bytes": x.numel() * x.element_size(),
           "runs": FASTPATH_RUNS, "bit_equal": True, "rungs": light,
           # what the two broker hops add to the chained run, per hop
           "broker_over_chained_ms_p50_per_hop": (
               light["broker"]["run_ms_p50"]
               - light["chained"]["run_ms_p50"]) / 2,
           "broker_over_chained_ms_p99_per_hop": (
               light["broker"]["run_ms_p99"]
               - light["chained"]["run_ms_p99"]) / 2,
           "hop_ms_p50": _pct(hop, 50), "hop_ms_p99": _pct(hop, 99),
           "fused_minus_chained_ms_p50": light["fused"]["run_ms_p50"]
           - light["chained"]["run_ms_p50"],
           "captures": rungs["fused"].captures,
           "single_dispatch": fastpath_single_dispatch(
               rungs["fused"], rungs["chained"], x),
           "donation": fastpath_donation(dev),
           "capture_cache": fastpath_capture_cache(dev)}
    del outs, rungs

    feats = _embeddings((1, 2048, 1024), 18, dev).to(torch.bfloat16)
    proj = (_embeddings((1024, cfg.d_model), 19, dev)
            * 1024 ** -0.5).to(torch.bfloat16)
    pos = torch.arange(2048, dtype=torch.int32, device=dev)[None]
    frontend = Stage("frontend", lambda f: f @ proj)
    backbone = Stage("backbone", lambda e: forward(params, e, pos, cfg)[0])
    pipes = {"chained": chain_stages([frontend, backbone]),
             "broker": _brokered([frontend, backbone]),
             "fused": fuse_stages([frontend, backbone], donate=False)}
    k2 = _kernel_counters()["K2"]
    k2.launches = 0
    logits = {name: fn(feats) for name, fn in pipes.items()}
    assert k2.launches == 3 * cfg.n_layers, k2.launches
    logits["fused_replay"] = pipes["fused"](feats)
    # a replay adds the launches its capture holds
    assert k2.launches == 4 * cfg.n_layers, k2.launches
    assert all(torch.equal(v, logits["chained"]) for v in logits.values()), \
        "frontend -> backbone: the rungs' logits differ"
    del logits
    e2e = {name: [] for name in pipes}
    for _ in range(5):
        for name, fn in pipes.items():
            e2e[name].append(_synced_ms(fn, feats))
    act = frontend.fn(feats)
    hop2 = [_synced_ms(broker_hop, act) for _ in range(5)]
    res["frontend_backbone"] = {
        "arch": cfg.name, "tokens": 2048, "bit_equal": True,
        "k2_launches_per_call": cfg.n_layers,
        "chained_ms_p50": statistics.median(e2e["chained"]),
        "broker_ms_p50": statistics.median(e2e["broker"]),
        "fused_ms_p50": statistics.median(e2e["fused"]),
        "fused_captures": pipes["fused"].captures,
        "hop_ms_p50": statistics.median(hop2),
        "hop_share_of_broker_e2e": statistics.median(hop2)
        / statistics.median(e2e["broker"])}
    del act, feats, proj, pipes
    emit(res)
    return res


def embeds_phases(dev, smi: str) -> dict:
    """score_embeds, embeds_check and serve_embeds for each embeds config
    at full width and depth (bf16, seeded weights with N(0, 1/d) embedding
    rows), one model at a time; then musicgen-large through the node and
    the fast path with phi-3-vision's backbone."""
    from repro_torch.configs.registry import get_config

    out = {}
    for arch in EMBEDS_ARCHS:
        cfg = get_config(arch)
        t0 = time.monotonic()
        params = _seeded_params(cfg, dev, 0)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        assert n_params == cfg.param_count(), (n_params, cfg.param_count())
        run = {"params": n_params, "init_s": time.monotonic() - t0,
               "score": score_embeds(cfg, params, dev, smi),
               "check": embeds_check(cfg, params, dev, smi)}
        run["serve"] = serve_embeds(cfg, params, dev, smi)
        if arch == "musicgen-large":
            run["node"] = serve_embeds_node(cfg, params, dev, smi,
                                            run["serve"]["tokens"])
        else:
            run["fastpath"] = fastpath_phase(cfg, params, dev, smi)
        out[arch] = run
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ================================================================== score
def _seeded_params(cfg, dev, seed):
    """Seeded random weights with N(0, 1/d) embedding rows, as the serve
    phase uses."""
    from repro_torch.models import init_params

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    params["embed"]["table"].mul_(cfg.d_model ** -0.5)
    return params


def _prompt(vocab, S, seed, dev):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, vocab, (1, S)).astype(
        np.int32)).to(dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
    return toks, pos


def score_check_phase(cfg, dev, S=2048, S_prompt=512) -> dict:
    """The full-width model cut to 2 layers: ``forward`` with K2 against the
    same forward with the plain attention, and ``forward``'s logits against
    ``paged_mixed_step`` prefilling the same prompt as one packed chunk
    (K2 and K1 computing the same attention)."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import (attention, forward, init_paged_pools,
                                    paged_mixed_step)

    small = cfg.replace(n_layers=2)
    params = _seeded_params(small, dev, 4)
    toks, pos = _prompt(small.vocab_size, S, 4, dev)
    kernel_fn = attention.fa_ops.flash_attention

    def plain_fn(q, k, v, *, positions=None, **kw):
        return fa_ref.attention_ref(q, k, v, **kw)

    logits = {}
    for name, fn in (("kernel", kernel_fn), ("plain", plain_fn)):
        attention.fa_ops.flash_attention = fn
        try:
            logits[name] = forward(params, toks, pos, small)[0]
        finally:
            attention.fa_ops.flash_attention = kernel_fn
    a, b = logits.pop("kernel"), logits.pop("plain")
    assert a.shape == (1, S, small.vocab_size) and a.dtype == torch.float32
    assert bool(torch.isfinite(a).all())
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    # bf16 activations: one bf16 ulp of an attention output, carried
    # through two layers, as in the model phase
    assert err <= 2e-2 * scale, (err, scale)
    argmax_kp = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
    del a, b

    toks, pos = _prompt(small.vocab_size, S_prompt, 5, dev)
    at = [0, S_prompt // 5, S_prompt // 2, S_prompt - 1]
    scored = forward(params, toks, pos, small)[0][0, at]
    bs = 16
    nb = S_prompt // bs
    pools = init_paged_pools(small, nb + 1, bs, device=dev)
    bt = torch.arange(1, nb + 1, dtype=torch.int32, device=dev)[None]
    packed = paged_mixed_step(
        params, pools, bt, toks[0], pos[0],
        torch.zeros(S_prompt, dtype=torch.int32, device=dev),
        torch.tensor([at], dtype=torch.int32, device=dev), small)[0]
    err2 = (scored - packed).abs().max().item()
    scale2 = packed.abs().max().item()
    assert err2 <= 2e-2 * scale2, (err2, scale2)
    res = {"phase": "score_check", "layers": 2, "tokens": S,
           "kernel_vs_plain_max_abs_err": err, "logit_scale": scale,
           "argmax_equal": argmax_kp, "prompt": S_prompt, "positions": at,
           "forward_vs_paged_max_abs_err": err2, "paged_logit_scale": scale2,
           "forward_vs_paged_argmax_equal":
           bool(torch.equal(scored.argmax(-1), packed.argmax(-1)))}
    emit(res)
    del params, pools
    torch.cuda.empty_cache()
    return res


# (arch, S): S = 8192 crosses gemma2's and danube-1.8b's 4096 window and
# gemma3's 1024; danube-3-4b's 8192 window needs S = 9216; mamba2-1.3b and
# zamba2-2.7b scan 32 chunks of 256; deepseek-moe-16b routes 16 groups of
# 512 tokens
SCORE_RUNS = [("gemma2-9b", 8192), ("gemma3-4b", 8192),
              ("h2o-danube-1.8b", 8192), ("h2o-danube-3-4b", 9216),
              ("mamba2-1.3b", 8192), ("zamba2-2.7b", 8192),
              ("deepseek-moe-16b", 8192)]


def score_phase(dev, smi: str, runs=SCORE_RUNS, smoke=False) -> list[dict]:
    """``forward`` at full width and full depth (bf16, seeded random
    weights), one sequence per config: a first forward builds up the
    allocator and checks the output, a second is timed (host clock around a
    forward that ends in synchronize) and must launch K2 once per attention
    layer and K3 once per mamba layer.  The aux loss is finite and at least
    1 - 1e-3 for a config with experts (the Switch loss's bound at balance,
    ``tests/test_models.py::test_moe_aux_loss_positive_and_bounded``), 0
    otherwise.  gemma2-9b's is then traced."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import forward, layer_specs

    results = []
    for arch, S in runs:
        cfg = get_config(arch, smoke=smoke)
        t0 = time.monotonic()
        params = _seeded_params(cfg, dev, 0)
        n_params = sum(t.numel() for t in _leaves(params))
        assert n_params == cfg.param_count(), (n_params, cfg.param_count())
        toks, pos = _prompt(cfg.vocab_size, S, 6, dev)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        logits, aux = forward(params, toks, pos, cfg)
        assert logits.shape == (1, S, cfg.vocab_size), logits.shape
        assert logits.dtype == torch.float32 and aux.dtype == torch.float32
        aux = float(aux)
        assert (math.isfinite(aux) and aux >= 1 - 1e-3 if cfg.n_experts
                else aux == 0.0), (arch, aux)
        assert bool(torch.isfinite(logits).all()), arch
        del logits
        torch.cuda.reset_peak_memory_stats()
        counters = _kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.monotonic()
        logits, _ = forward(params, toks, pos, cfg)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        kinds = [spec.kind for spec in layer_specs(cfg)]
        n_mamba = kinds.count("mamba")
        assert launches == {"K2": len(kinds) - n_mamba, "K3": n_mamba,
                            "K4": 0}, (arch, launches)
        assert bool(torch.isfinite(logits).all()), arch
        res = {"phase": "score", "arch": arch, "card": smi,
               "n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "params": n_params, "B": 1, "S": S, "dtype": cfg.dtype,
               "k2_launches": launches["K2"], "k3_launches": launches["K3"],
               "aux": aux, "init_s": init_s, "wall_s": wall,
               "tokens_per_s": S / wall,
               "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        emit(res)
        results.append(res)
        del logits
        if arch == "gemma2-9b":
            score_trace_phase(cfg, params, toks, pos)
        del params
        torch.cuda.empty_cache()
    return results


def score_trace_phase(cfg, params, toks, pos) -> None:
    """One score forward under torch.profiler: device time by group (K2,
    dense products, other) and the device's idle share (informational)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import forward

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        logits, _ = forward(params, toks, pos, cfg)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    del logits
    emit({"phase": "score_trace", "arch": cfg.name, "S": toks.shape[1],
          **_device_time(prof, wall, {"K2": ("flash_attention",),
                                      "gemm": GEMM_KEYS})})


def _device_time(prof, wall, groups) -> dict:
    """Device self time by kernel group (a kernel counts in the first group
    one of whose patterns its name holds) and the busy / idle share of the
    host wall time of a profiled run."""
    kernels = [(us, n, key) for key, (n, us) in device_kernels(prof).items()
               if us > 0]
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    share = dict.fromkeys(groups, 0.0)
    for us, _, key in kernels:
        g = next((g for g, pats in groups.items()
                  if any(p in key.lower() for p in pats)), None)
        if g is not None:
            share[g] += us / 1e3
    share["other"] = busy_ms - sum(share.values())
    return {"wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms if kernels else "not measured",
            "device_idle_share": 1 - busy_ms / (wall * 1e3) if kernels
            else "not measured",
            "group_ms": share,
            "top": [{"kernel": key[:90], "launches": n, "ms": us / 1e3}
                    for us, n, key in kernels[:8]]}


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ================================================================ training
# zamba2-2.7b runs both kernels on the training path: its shared attention
# through K2 (B 2, S 2048, H = K = 32, D 160, bf16; 9 applications) and its
# 54 Mamba-2 layers through K3 (H 80, P 64, N 64, chunk 256); with remat
# each runs again in the backward's recompute
TRAIN_ARCH = "zamba2-2.7b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 2048, 6
TRAIN_PEAK_LIMIT = 60e9               # bytes: the full-depth step's peak
TRAIN_F32_LOSS_RTOL = 1e-5
# of the leaf's max-abs: between train_check's lower reading (the plain
# versions off by one f32 unit in the last place) and its upper readings
# (a kernel on bf16-rounded operands), both measured in every run
TRAIN_F32_LEAF_TOL = 2e-4
TRAIN_BF16_NORM_RTOL = 2e-2
TRAIN_BF16_MIN_COSINE = 0.995
TRAIN_BOUND = ("6 * params * tokens / 989e12 (bf16 tensor cores): the "
               "model-FLOPs bound of one step, forward and backward, "
               "without remat's recompute")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape and bits (a bf16 leaf compared as its bits)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(_bits(a), _bits(b)))


def _named_tensors(tree) -> dict:
    """name → tensor of a state tree, named as its checkpoint names it."""
    from repro_torch.tree import named_leaves

    return dict(named_leaves(tree))


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in _named_tensors(tree).values())


def _grad_case(name, fn, plain, counter, inputs, dout, reps, hold) -> dict:
    """One kernel under autograd against its plain version: ``fn(*t)`` the
    wrapper's output that the model uses, ``plain(*t)`` the plain
    version's; ``hold(out, plain_out, inputs)`` asserts the kernel's
    forward against the plain forward on the same inputs, at the kernel
    phases' tolerance, and returns its readings."""
    with torch.no_grad():
        direct, again = fn(*inputs), fn(*inputs)
    assert bit_equal(direct, again), (name, "two calls differ")
    leaves = [t.detach().requires_grad_() for t in inputs]
    counter.launches = 0
    out = fn(*leaves)
    assert counter.launches == 1, (name, counter.launches)
    assert out.grad_fn is not None and bit_equal(out.detach(), direct), name
    grads = torch.autograd.grad(out, leaves, dout, retain_graph=True)
    assert all(bool(torch.isfinite(t).all()) for t in grads), name
    ref_leaves = [t.detach().requires_grad_() for t in inputs]
    ref_out = plain(*ref_leaves)
    held = hold(out.detach(), ref_out.detach(), inputs)
    want = torch.autograd.grad(ref_out, ref_leaves, dout, retain_graph=True)
    equal = [bit_equal(a, b) for a, b in zip(grads, want)]
    assert all(equal), (name, equal)
    del grads, want
    res = {"name": name, "forward_vs_plain": held,
           "forward_equals_direct_call": True,
           "two_calls_equal": True, "grads_bit_equal": equal,
           "launches_per_forward": 1,
           "forward_ms": cuda_ms(lambda: fn(*leaves), reps[0]),
           "backward_ms": cuda_ms(lambda: torch.autograd.grad(
               out, leaves, dout, retain_graph=True), reps[1]),
           "plain_forward_ms": cuda_ms(lambda: plain(*ref_leaves), reps[1]),
           "plain_backward_ms": cuda_ms(lambda: torch.autograd.grad(
               ref_out, ref_leaves, dout, retain_graph=True), reps[1])}
    return res


def unembed_grad_check(cfg, dev, T, g) -> dict:
    """The bf16 head product's backward on the card (``torch.mm`` with an
    f32 out has none; ``layers._UnembedF32`` gives it the upcast
    product's): its grads bit-equal to the upcast product's autograd
    grads at the model's head shapes."""
    from repro_torch.models import layers

    x = (torch.randn((T, cfg.d_model), generator=g, device=dev)
         ).to(torch.bfloat16).requires_grad_()
    table = (torch.randn((cfg.vocab_size, cfg.d_model), generator=g,
                         device=dev) * cfg.d_model ** -0.5
             ).to(torch.bfloat16).requires_grad_()
    dout = torch.randn((T, cfg.vocab_size), generator=g, device=dev)
    out = layers.unembed({"table": table}, x)
    assert out.dtype == torch.float32 and out.grad_fn is not None
    got = torch.autograd.grad(out, (x, table), dout)
    want = torch.autograd.grad(torch.mm(x.float(), table.float().t()),
                               (x, table), dout)
    equal = [bit_equal(a, b) for a, b in zip(got, want)]
    assert all(equal), equal
    return {"T": T, "V": cfg.vocab_size, "d": cfg.d_model,
            "grads_bit_equal_to_upcast_product": equal}


def grad_kernel_phase(dev, B=TRAIN_B, S=TRAIN_S, reps=(10, 3)) -> dict:
    """K2 and K3 under autograd at zamba2-2.7b's training shapes (bf16 q,
    k, v; bf16 x, B, C and f32 dt, A; y's grad only, as the model uses
    y): the Function's forward bit-equal to a direct call of the kernel
    and held to the plain forward on the same inputs at the kernel phases'
    tolerances (K2 within one bf16 rounding of the f32 plain value, K3's y
    within ``SSD_TOL``), two direct calls bit-equal (the forward is
    deterministic), one launch per forward, and its grads (dq, dk, dv; dx, ddt, dA, dB_, dC_) finite
    and bit-equal to the plain version's autograd grads on the same
    inputs: the backward is that same plain recompute.  Times (CUDA
    events, median): forward and backward through the Function, and the
    plain version's.  First the head product's backward
    (``unembed_grad_check``)."""
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssd import ops as so
    from repro_torch.kernels.ssd import ref as so_ref

    cfg = get_config(TRAIN_ARCH)
    g = torch.Generator(device=dev).manual_seed(300)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    bf = torch.bfloat16
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Hs, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    scale = D ** -0.5

    def hold_k2(out, plain_out, qkv):
        # as flash_kernel_phase holds K2's bf16 output: within 2e-2 of the
        # plain bf16 output, and each element within one bf16 rounding of
        # the plain f32 value on the same inputs
        err = (out.float() - plain_out.float()).abs().max().item()
        want32 = fa_ref.attention_ref(*(t.float() for t in qkv), scale=scale)
        over = ((out.float() - want32).abs()
                / (want32.abs() * ROUND_BF16 + F32_TOL)).max().item()
        assert err <= 2e-2 and over <= 1.0, ("flash_attention", err, over)
        return {"max_abs_err": err, "tol": 2e-2,
                "err_over_rounding_bound": over}

    def hold_k3(y, plain_y, _):
        # as ssd_kernel_phase holds K3's y: |y - plain| <= atol + rtol|plain|
        atol, rtol = SSD_TOL
        err = (y - plain_y).abs()
        over = (err / (atol + rtol * plain_y.abs())).max().item()
        assert over <= 1.0, ("ssd", over)
        return {"max_abs_err": err.max().item(), "tol": SSD_TOL,
                "err_over_tol": over}

    attn = _grad_case(
        "flash_attention", lambda q, k, v: fa.flash_attention(q, k, v),
        lambda q, k, v: fa_ref.attention_ref(q, k, v, scale=scale),
        fa.flash_attention,
        [rnd(B, S, H, D).to(bf), rnd(B, S, K, D).to(bf),
         rnd(B, S, K, D).to(bf)], rnd(B, S, H, D).to(bf), reps, hold_k2)
    chunk = cfg.ssm_chunk
    scan = _grad_case(
        "ssd", lambda *t: so.ssd(*t, chunk=chunk)[0],
        lambda *t: so_ref.ssd_chunked_ref(*t, chunk=chunk)[0], so.ssd,
        [rnd(B, S, Hs, P).to(bf), F.softplus(rnd(B, S, Hs)),
         -torch.exp(rnd(Hs) * 0.5), (rnd(B, S, N) / N ** 0.5).to(bf),
         (rnd(B, S, N) / N ** 0.5).to(bf)], rnd(B, S, Hs, P), reps, hold_k3)
    res = {"phase": "grad_kernel", "arch": cfg.name,
           "unembed": unembed_grad_check(cfg, dev, B * S, g),
           "K2": dict(attn, shape=f"B={B} S={S} H=K={H} D={D} bf16"),
           "K3": dict(scan, shape=f"B={B} S={S} H={Hs} P={P} N={N} chunk "
                                  f"{chunk}, bf16 x/B/C")}
    emit(res)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _flip_last_bit(t: torch.Tensor) -> torch.Tensor:
    """``t`` with each element's lowest mantissa bit flipped: every f32
    element one unit in the last place away, the same way on every call."""
    return (_bits(t) ^ 1).view(t.dtype)


def cuda_routes() -> dict:
    """Stand-ins for K2's and K3's CUDA routes (``ops._launch``), by name:
    ``plain`` the plain versions; ``plain_ulp`` the plain versions with
    every output element moved by one unit in its last place
    (``_flip_last_bit``): f32 rounding error and nothing else; and
    ``bf16_operands`` the kernels on operands rounded to bf16 (q, k, v; x,
    B, C), a kernel off by one bf16 rounding of its inputs."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssd import ops as so
    from repro_torch.kernels.ssd import ref as so_ref

    k2, k3 = fa._launch, so._launch
    bf = torch.bfloat16

    def plain_k2(q, k, v, window, softcap, scale):
        return fa_ref.attention_ref(q, k, v, window=window, softcap=softcap,
                                    scale=scale)

    def plain_k3(x, dt, A, B_, C_, D, h0, chunk):
        return so_ref.ssd_chunked_ref(x, dt, A, B_, C_, D, chunk=chunk, h0=h0)

    return {
        "plain": (plain_k2, plain_k3),
        "plain_ulp": (
            lambda *a: _flip_last_bit(plain_k2(*a)),
            lambda *a: tuple(map(_flip_last_bit, plain_k3(*a)))),
        "bf16_operands": (
            lambda q, k, v, *a: k2(q.to(bf), k.to(bf), v.to(bf), *a).to(
                q.dtype),
            lambda x, dt, A, B_, C_, *a: k3(x.to(bf), dt, A, B_.to(bf),
                                            C_.to(bf), *a))}


@contextlib.contextmanager
def swapped_routes(k2=None, k3=None):
    """K2's and / or K3's CUDA route replaced by ``k2`` / ``k3`` (their
    autograd Functions, whose backward is the plain version, and
    everything else unchanged)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as so

    saved = fa._launch, so._launch
    fa._launch, so._launch = k2 or fa._launch, k3 or so._launch
    try:
        yield
    finally:
        fa._launch, so._launch = saved


def _leaf_errors(a: dict, b: dict) -> dict:
    """Each gradient leaf's largest error over its max-abs, ``a`` against
    ``b`` (name -> tensor)."""
    out = {}
    for n in b:
        scale = b[n].abs().max().item()
        err = (a[n] - b[n]).abs().max().item()
        out[n] = err / scale if scale else err
    return out


def train_check_phase(dev, n_layers=6, S=TRAIN_S) -> dict:
    """zamba2-2.7b at full width cut to one group (``reduced``: n_layers 54
    -> 6: six Mamba-2 layers and one shared-attention application), B 1,
    S 2048, ``synthetic_batch`` seed 0: the loss and every gradient leaf
    through the port with the kernels (K2 and K3 in the forward and again
    in remat's recompute), and again with the plain versions in the
    wrappers' CUDA route.  Tolerances: at f32 (the kernels' FMA routes)
    the loss within 1e-5 relative and each gradient leaf within
    ``TRAIN_F32_LEAF_TOL`` of that leaf's max-abs; at bf16 the global
    gradient norm within 2e-2 relative and every leaf's cosine at least
    ``TRAIN_BF16_MIN_COSINE``.

    At f32 the same comparison is also read with one kernel at a time
    (the other plain), and for the two stand-ins of ``cuda_routes``: the
    plain versions off by one unit in the last place (the lower reading:
    what f32 rounding of the kernels' outputs alone does to the
    gradients), and each kernel on bf16-rounded operands in turn (the
    upper readings, which must exceed the limit: the check tells such a
    kernel from a right one)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import layer_specs
    from repro_torch.training import (DataConfig, ShardedBatcher,
                                      make_loss_fn, value_and_grad)

    full = get_config(TRAIN_ARCH)
    small = full.replace(n_layers=n_layers)
    kinds = [s.kind for s in layer_specs(small)]
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("shared_attn")
    batch = next(ShardedBatcher(small, DataConfig(batch=1, seq_len=S),
                                device=dev))
    routes = cuda_routes()
    plain_k2, plain_k3 = routes["plain"]
    res = {"phase": "train_check", "arch": small.name,
           "reduced": {"n_layers": [full.n_layers, n_layers]}, "B": 1,
           "S": S, "tolerances": {
               "float32": {"loss_rtol": TRAIN_F32_LOSS_RTOL,
                           "leaf_atol_of_max_abs": TRAIN_F32_LEAF_TOL},
               "bfloat16": {"grad_norm_rtol": TRAIN_BF16_NORM_RTOL,
                            "min_cosine": TRAIN_BF16_MIN_COSINE}}}
    for dtype in ("float32", "bfloat16"):
        cfg = small.replace(dtype=dtype)
        params = _seeded_params(cfg, dev, 7)
        loss_fn = make_loss_fn(cfg)
        counters = _kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        (loss, _), grads = value_and_grad(loss_fn, params, batch)
        launches = {k: fn.launches for k, fn in counters.items()}
        # remat: each kernel again in the backward's recompute
        assert launches == {"K2": 2 * n_attn, "K3": 2 * n_mamba, "K4": 0}, \
            launches
        with swapped_routes(plain_k2, plain_k3):
            (loss_p, _), grads_p = value_and_grad(loss_fn, params, batch)
        a, b = _named_tensors(grads), _named_tensors(grads_p)
        assert a.keys() == b.keys()
        finite = [n for n in b if not (bool(torch.isfinite(a[n]).all())
                                       and bool(torch.isfinite(b[n]).all()))]
        assert not finite, ("gradient leaves not finite", dtype, finite)
        loss, loss_p = float(loss), float(loss_p)
        assert math.isfinite(loss) and math.isfinite(loss_p), (loss, loss_p)
        norm = math.sqrt(sum(float(t.float().square().sum())
                             for t in a.values()))
        norm_p = math.sqrt(sum(float(t.float().square().sum())
                               for t in b.values()))
        out = {"loss": loss, "loss_plain": loss_p,
               "loss_rel_err": abs(loss - loss_p) / abs(loss_p),
               "grad_norm": norm, "grad_norm_plain": norm_p,
               "grad_norm_rel_err": abs(norm - norm_p) / norm_p,
               "launches": launches, "leaves": len(a)}
        if dtype == "float32":
            ratio = _leaf_errors(a, b)
            worst = sorted(ratio, key=ratio.get, reverse=True)
            out["err_over_max_abs"] = {n: ratio[n] for n in worst[:8]}
            out["leaves_over_tol"] = [n for n in worst
                                      if ratio[n] > TRAIN_F32_LEAF_TOL]
            ok = (out["loss_rel_err"] <= TRAIN_F32_LOSS_RTOL
                  and not out["leaves_over_tol"])
            del a, grads
            # the same reading for each stand-in: (K2's route, K3's route)
            readings = {}
            for name, (r2, r3) in {
                    "kernel_K2_only": (None, plain_k3),
                    "kernel_K3_only": (plain_k2, None),
                    "plain_ulp": routes["plain_ulp"],
                    "K2_bf16_operands": (routes["bf16_operands"][0],
                                         plain_k3),
                    "K3_bf16_operands": (plain_k2,
                                         routes["bf16_operands"][1])
                    }.items():
                with swapped_routes(r2, r3):
                    (loss_r, _), grads_r = value_and_grad(loss_fn, params,
                                                          batch)
                ratio = _leaf_errors(_named_tensors(grads_r), b)
                n = max(ratio, key=ratio.get)
                readings[name] = {
                    "loss_rel_err": abs(float(loss_r) - loss_p) / abs(loss_p),
                    "worst_leaf": n, "worst_err_over_max_abs": ratio[n],
                    "in_proj_err_over_max_abs": max(
                        v for k, v in ratio.items() if "in_proj" in k)}
                del grads_r
            out["readings"] = readings
            # the check tells a kernel off by one bf16 rounding of its
            # operands from a right one
            ok = ok and all(
                readings[k]["worst_err_over_max_abs"] > TRAIN_F32_LEAF_TOL
                for k in ("K2_bf16_operands", "K3_bf16_operands"))
        else:
            cos = {n: float(torch.nn.functional.cosine_similarity(
                a[n].float().flatten(), b[n].float().flatten(), dim=0))
                for n in b}
            out["cosine"] = cos
            out["min_cosine"] = min(cos.values())
            ok = (out["grad_norm_rel_err"] <= TRAIN_BF16_NORM_RTOL
                  and out["min_cosine"] >= TRAIN_BF16_MIN_COSINE)
            del a, grads
        res[dtype] = dict(out, within_tolerance=ok)
        del params, grads_p, b
        gc.collect()
        torch.cuda.empty_cache()
    emit(res)
    assert res["float32"]["within_tolerance"], res["float32"]
    assert res["bfloat16"]["within_tolerance"], {
        k: v for k, v in res["bfloat16"].items() if k != "cosine"}
    return res


def train_trace(step, state, batch) -> dict:
    """One more train step under torch.profiler (informational): device
    time by group (K2's and K3's forward kernels, the dense products,
    which include the plain backwards' einsums, and the rest) and the
    device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    return _device_time(prof, wall, {"K2": ("flash_attention",),
                                     "K3": ("ssd_",), "gemm": GEMM_KEYS})


def train_phase(dev, smi: str, B=TRAIN_B, S=TRAIN_S,
                steps=TRAIN_STEPS) -> dict:
    """zamba2-2.7b at full width and depth, bf16, seeded weights (N(0, 1/d)
    embedding rows), AdamW (its ``cfg.optimizer``; lr 1e-3, warmup_steps 1,
    weight decay 0.1), ``max_grad_norm`` 1.0, remat on, ``synthetic_batch``
    seed 0, B 2 x S 2048, ``steps`` steps.  Every loss and gradient norm
    finite, the norm above 0, the last loss below the first; each step
    launches K2 2 x 9 times and K3 2 x 54 times (forward and recompute);
    the peak memory under 60 GB.  Step time (host clock around a step that
    ends in synchronize), tokens/s, peak memory and the step's share of its
    model-FLOPs bound (``TRAIN_BOUND``); then one more step traced
    (``train_trace``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import layer_specs, stacked_leaves
    from repro_torch.training import (DataConfig, ShardedBatcher, TrainState,
                                      get_optimizer, make_train_step)

    cfg = get_config(TRAIN_ARCH)
    assert cfg.remat and cfg.optimizer == "adamw"
    kinds = [s.kind for s in layer_specs(cfg)]
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("shared_attn")
    opt = get_optimizer(cfg.optimizer, lr=1e-3, warmup_steps=1)
    t0 = time.monotonic()
    params = _seeded_params(cfg, dev, 0)
    n_params = sum(t.numel() for t in _leaves(params))
    assert n_params == cfg.param_count(), (n_params, cfg.param_count())
    state = TrainState(params, opt.init(stacked_leaves(params, cfg)))
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    step = make_train_step(cfg, opt, max_grad_norm=1.0)
    batches = ShardedBatcher(cfg, DataConfig(batch=B, seq_len=S, seed=0),
                             device=dev)
    counters = _kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, launches, metrics = [], [], []
    for _ in range(steps):
        batch = next(batches)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.monotonic()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        launches.append({k: fn.launches for k, fn in counters.items()})
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated()
    traced = train_trace(step, state, next(batches))
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    assert all(map(math.isfinite, losses + norms)), (losses, norms)
    assert min(norms) > 0, norms
    assert losses[-1] < losses[0], losses
    assert int(metrics[-1]["step"]) == steps
    want = {"K2": 2 * n_attn, "K3": 2 * n_mamba, "K4": 0}
    assert all(l == want for l in launches), (launches, want)
    assert peak < TRAIN_PEAK_LIMIT, peak
    p50 = statistics.median(step_s)
    bound_s = 6 * n_params * B * S / PEAK[torch.bfloat16]
    res = {"phase": "train", "arch": cfg.name, "card": smi,
           "params": n_params, "dtype": cfg.dtype, "optimizer": opt.name,
           "lr": 1e-3, "warmup_steps": 1, "max_grad_norm": 1.0,
           "remat": cfg.remat, "B": B, "S": S, "steps": steps,
           "losses": losses, "grad_norms": norms,
           "launches_per_step": launches[-1], "init_s": init_s,
           "step_s": step_s, "step_p50_s": p50,
           "tokens_per_s": B * S / p50,
           "state_bytes": {"params": _tree_bytes(state.params),
                           "moments": _tree_bytes(state.opt_state.mu)
                           + _tree_bytes(state.opt_state.nu)},
           "peak_mem_bytes": peak, "bound_ms": bound_s * 1e3,
           "bound": TRAIN_BOUND, "share_of_bound": bound_s / p50,
           "trace": traced}
    emit(res)
    del state, params, metrics, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def train_ft_phase(dev, n_layers=6, S=1024, steps=3) -> dict:
    """zamba2-2.7b at full width cut to one group (``reduced``: n_layers 54
    -> 6), bf16, Adafactor, B 1 x S 1024, through ``FaultTolerantLoop``
    with a ``CheckpointManager`` over a persistent log in a temporary
    directory (removed at the end), ``ckpt_every`` 2, 3 steps: saves at
    steps 2 (asynchronous) and 3 (the final stable one), each save's bytes
    and seconds.  A new loop over the same log resumes at step 3 with
    every leaf bit-equal to the first loop's final state; the next step's
    loss from both states is bit-equal (the forward is deterministic); a
    time-travel restore to a time between the two saves returns step 2."""
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.core.objects import monotonic_ns
    from repro_torch.kernels import build
    from repro_torch.models import stacked_leaves
    from repro_torch.training import (CheckpointManager, DataConfig,
                                      FaultTolerantLoop, ShardedBatcher,
                                      TrainState, clone_state,
                                      get_optimizer, make_train_step)

    full = get_config(TRAIN_ARCH)
    cfg = full.replace(n_layers=n_layers)
    opt = get_optimizer("adafactor")
    step = make_train_step(cfg, opt)
    dcfg = DataConfig(batch=1, seq_len=S)

    def fresh(seed):
        params = _seeded_params(cfg, dev, seed)
        return TrainState(params, opt.init(stacked_leaves(params, cfg)))

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        path = os.path.join(tmp, "ckpt.log")
        ck = CheckpointManager(path)
        saves, marks = [], {}
        save = ck.save

        def timed_save(at, tree, *, wait=True):
            t0 = time.monotonic()
            save(at, tree, wait=wait)
            saves.append({"step": at, "bytes": _tree_bytes(tree),
                          "wait_stable": wait,
                          "seconds": time.monotonic() - t0})

        ck.save = timed_save
        loop = FaultTolerantLoop(step, fresh(0), ckpt=ck, ckpt_every=2)
        final = loop.run(ShardedBatcher(cfg, dcfg, device=dev), steps,
                         metrics_cb=lambda s, m, dt: marks.setdefault(
                             s, (monotonic_ns(), float(m["loss"]), dt)))
        assert [s["step"] for s in saves] == [2, 3], saves
        kept = clone_state(final)
        # between the two saves: the step-2 checkpoint
        back, old = ck.restore(kept, at_time_ns=marks[3][0])
        assert back == 2 and int(old.opt_state.step) == 2, back
        del old
        ck.close()
        log_bytes = os.path.getsize(path)
        ck2 = CheckpointManager(path)
        t0 = time.monotonic()
        loop2 = FaultTolerantLoop(step, fresh(1), ckpt=ck2, ckpt_every=2)
        restore_s = time.monotonic() - t0
        assert loop2.step == steps, loop2.step
        a, b = _named_tensors(loop2.state), _named_tensors(kept)
        assert a.keys() == b.keys()
        differ = [n for n in b if not bit_equal(a[n], b[n])]
        assert not differ, differ
        nxt = ShardedBatcher(cfg, dcfg, device=dev)
        nxt.step = steps
        batch = next(nxt)
        _, m_kept = step(kept, batch)
        _, m_back = step(loop2.state, batch)
        assert bit_equal(m_kept["loss"], m_back["loss"]), (
            float(m_kept["loss"]), float(m_back["loss"]))
        ck2.close()
    res = {"phase": "train_ft", "arch": cfg.name,
           "reduced": {"n_layers": [full.n_layers, n_layers]},
           "params": sum(t.numel() for t in _leaves(final.params)),
           "optimizer": opt.name, "B": 1, "S": S, "steps": steps,
           "losses": [marks[s][1] for s in sorted(marks)],
           "step_s": [marks[s][2] for s in sorted(marks)],
           "saves": saves, "log_bytes": log_bytes, "restore_s": restore_s,
           "resumed_at": loop2.step, "leaves_bit_equal": len(b),
           "next_loss": float(m_back["loss"]), "next_loss_bit_equal": True,
           "time_travel_step": back}
    emit(res)
    del final, kept, loop, loop2, a, b
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ================================================= sharded programs (P16)
# the dense entry points and the train step over a (data, model) mesh of
# logical devices on the card (``launch.spmd.Program``), each held against
# the same program on one logical device and against the dry run's trace
# of the same mesh and shapes on meta (``launch.dryrun.trace``)
# (arch, mesh, B, S, steps); (arch, mesh, B, S, decode steps); (arch,
# mesh, prompt, decode steps at B 1)
SHARDED_TRAIN = ("h2o-danube-1.8b", (2, 2), 4, 4096, 3, None)
# the head and loss split over the vocabulary: gemma2-9b (V 256,000, tied,
# final softcap 30) on (data 1, model 2), cut to 4 layers so that the
# one-device and the sharded AdamW states both fit; B x S = 4,096 tokens,
# at least d_model (3,584), so that the f32 update of a shard's
# embedding rows (V/2 x d x 4 bytes) stays inside the allocation bound
# of one shard's f32 logits, B x S x V/2 x 4 bytes
SHARDED_VOCAB = ("gemma2-9b", (1, 2), 2, 2048, 2, 4)
SHARDED_SERVE = ("zamba2-2.7b", (1, 2), 2, 4096, 32)
SHARDED_SEQ = ("h2o-danube-1.8b", (2, 2), 4000, 16)
# the same prompt length and decode steps over caches split over both the
# batch and the sequence (``seq_shard_cache``): (mesh, B), the caches'
# batch unsplit on (data 2, model 2) and over 'pod' on (pod 2, data 2,
# model 1); distinct prompts per batch row
SHARDED_SEQ_BATCHES = (((2, 2), 2), ((2, 2, 1), 4))
# params over 'data' (``make_rules(..., fsdp=True)``): SHARDED_TRAIN's
# steps, then a prefill of (B, S) and teacher-forced decode steps
SHARDED_FSDP = (2, 4000, 16)
# the experts over 'data' (Stage 5): deepseek-moe-16b at full width on
# (data 2, model 2), (arch, mesh, B, S, decode steps, a second prompt's
# length: B x 120 is one group of 480 over both rows, capacity 57); its
# train steps cut to 3 layers (one dense, two MoE: AdamW's f32 moments of
# all 16.4B params would take 131 GB); an f32 check cut to 4 layers
SHARDED_MOE = ("deepseek-moe-16b", (2, 2), 4, 2048, 16, 120)
SHARDED_MOE_TRAIN = ("deepseek-moe-16b", (2, 2), 4, 2048, 3, 3)
SHARDED_MOE_F32 = (4, 512, 4)          # layers, prompt length, decode steps
SHARDED_MOE_F32_TOL = 1e-3             # logits, over the one-device scale
# bf16 at full depth is chaotic: a rounding change flips near-tie routing
# choices, and capacity hands each flip on to the other tokens of its
# group.  The one-device program against itself with K2's plain version
# in K2's place (``bf16_floor``) drifts from 3.3e-3 at the first MoE
# layer's input to 0.94 at the last, its logits 1.11 of their scale apart
# (first card run, NVIDIA H100 80GB HBM3, 700.00 W).  So the sharded bf16
# run's MoE inputs are held, layer by layer, within this factor of that
# drift (plus SHARDED_LOGIT_TOL's slack), and its logits only reported;
# the f32 cut above holds the logits themselves
SHARDED_MOE_FLOOR_FACTOR = 2.0
# a token whose routing may differ between two f32 runs that sum in
# different orders: two of its top-(k+1) router probabilities within this
# of each other, relative.  Set after the first f32 runs on the card
# (NVIDIA H100 80GB HBM3, 700.00 W) swapped one token's slot order in
# layer 3's 12,288 entries, at a relative gap of 1.34e-5
MOE_TIE_RTOL = 1e-4
MOE_AUX_RTOL = 1e-2
# the bf16 bounds, written down before the first run on the card: each
# sharded step's loss within 1e-2 of the one-device step's (relative), every
# logit within 5e-2 of the one-device logits' largest magnitude, and the
# greedy token equal wherever the one-device top-two margin exceeds twice
# that bound
SHARDED_LOSS_RTOL = 1e-2
SHARDED_LR = 1e-4                  # AdamW, warmup 1: a step the loss follows
# the train steps' state after SHARDED_TRAIN's steps against one device's,
# each the largest over the steps or the worst leaf: the pre-clip gradient
# norm (relative), AdamW's first moment (the clipped gradients' average)
# and the parameters' change (each ||sharded - one|| / ||one||).  Set
# between two readings on the card (NVIDIA H100 80GB HBM3, 700.00 W): the
# sound steps 6.6e-3, 0.075, 0.059; the control that drops batch row 1's
# gradients (``_drop_row_grads``) 0.55, 0.94, 0.84
SHARDED_NORM_RTOL = 5e-2
SHARDED_MU_RTOL = 0.25
SHARDED_DELTA_RTOL = 0.2
SHARDED_LOGIT_TOL = 5e-2
DRYRUN_JOBS = 8                    # cells traced at once (8 host cores)
DRYRUN_TIMEOUT_S = 420


def _shard_tensors(tree) -> list:
    """Every tensor of ``tree``, a ShardedTensor's shards each."""
    from repro_torch.core.sharded import ShardedTensor
    from repro_torch.tree import tree_leaves

    out = []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, ShardedTensor):
            out += leaf.shards
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def held_bytes(tree) -> int:
    """Bytes of the distinct storages the tensors of ``tree`` hold on the
    card (a view that keeps a larger storage alive counts it whole)."""
    seen = {}
    for t in _shard_tensors(tree):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _mesh_on(shape, device):
    """A (data, model) or (pod, data, model) mesh of ``shape`` over
    logical devices on ``device``."""
    from repro_torch.launch.mesh import (_make_mesh, logical_devices,
                                         make_host_mesh)

    n = int(np.prod(shape))
    with logical_devices(n, device):
        if len(shape) == 3:
            return _make_mesh(shape, ("pod", "data", "model"))
        return make_host_mesh(n, model=shape[-1])


def predicted(cfg, shape, B, S, kind, whole: bool = True, **rules) -> dict:
    """The dry run's trace of this program on the same mesh on meta, every
    shard run: the bytes each device's arguments hold, the step's FLOPs on
    the card (every shard, the common share once), its peak, and the
    roofline bound max(FLOPs / 989e12, argument bytes / 3.35e12).
    ``whole`` False: one shard runs, standing for every device (the dry
    run's own per-device figures, times the devices; a quarter of the
    host's time on a (2, 2) mesh).  ``rules``: ``make_rules``' options
    (``fsdp``, ``seq_shard_cache``)."""
    from repro_torch.configs.registry import Shape
    from repro_torch.launch.dryrun import trace
    from repro_torch.launch.sharding import make_rules

    t0 = time.monotonic()
    mesh = _mesh_on(shape, "meta")
    tr = trace(cfg, mesh, Shape(f"sharded_{kind}", S, B, kind),
               rules=make_rules(cfg, mesh, batch=B, **rules), whole=whole)
    n = 1 if whole else mesh.size
    flops = (tr["counter"].total_flops() if whole
             else float(tr["flops"]) * n)
    args = sum(tr["args"])
    return {"args_per_device": tr["args"], "args": args, "flops": flops,
            "peak": args + (tr["counter"].total_peak if whole
                            else tr["peak_bytes"] * n),
            "collective_bytes": dict(tr["counter"].ledger.bytes),
            "bound_s": max(flops / PEAK[torch.bfloat16], args / MEM_BW),
            "trace_s": time.monotonic() - t0}


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def _counted(fn) -> tuple:
    """``fn()`` with the wrappers' counts set to 0 just before: (its
    result, each kernel's launches in it)."""
    counters = _kernel_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    return out, {k: c.launches for k, c in counters.items()}


def _drop_row_grads():
    """A planted fault for the train check's control: ``Program`` whose
    gradient reduction keeps only the first batch row's part of every
    leaf (the other rows' gradients dropped)."""
    from repro_torch.launch.spmd import Program

    class DropRowGrads(Program):
        def _grad_parts(self, acc, j, shards, rows):
            return super()._grad_parts(acc, j, shards, rows[:1])

    return DropRowGrads


def _drop_vocab_shards():
    """A planted fault for the split head's control: ``Program`` whose
    vocab-parallel loss reads the first shard's slice of the vocabulary
    only (the other shards' Σ exp and target logits dropped)."""
    import dataclasses

    from repro_torch.launch.spmd import Program
    from repro_torch.training.train import vocab_nll_sum

    class DropVocabShards(Program):
        def _nll(self, logits, targets, mask, tp):
            if tp.vocab is None:
                return super()._nll(logits, targets, mask, tp)
            first = dataclasses.replace(tp, devices=tp.devices[:1],
                                        vocab=tp.vocab[:1], group=None)
            return vocab_nll_sum(logits[:1], targets, mask, first)

    return DropVocabShards


def train_agreement(prog, state, one: dict, norms: list,
                    one_norms: list) -> dict:
    """The sharded state after the steps against one device's (``one``:
    its initial params ``p0``, final params ``p`` and first moment ``mu``,
    on the card): the largest relative distance of the pre-clip gradient
    norms over the steps, and the worst leaf's ||sharded - one|| / ||one||
    of AdamW's first moment and of the parameters' change.  ``state`` may
    be another one-device state (its leaves plain tensors)."""
    from repro_torch.tree import named_leaves

    def worst(placed, ref, base=None):
        dists = []
        base = dict(base) if base is not None else None
        for name, st in named_leaves(placed):
            a = (st if isinstance(st, torch.Tensor) else st.gather(dev)
                 ).float()
            b = ref[name].float()
            if base is not None:
                a, b = a - base[name].float(), b - base[name].float()
            den = torch.linalg.vector_norm(b)
            dists.append((torch.linalg.vector_norm(a - b)
                          / torch.clamp(den, min=1e-30), name))
            del a, b
        vals = torch.stack([d for d, _ in dists]).tolist()
        i = int(np.argmax(vals))
        return vals[i], dists[i][1]

    dev = one["p0"]["final_norm/scale"].device
    mu, mu_leaf = worst(state.opt_state.mu, one["mu"])
    delta, delta_leaf = worst(state.params, one["p"], one["p0"].items())
    norm = max(abs(a - b) / b for a, b in zip(norms, one_norms))
    return {"grad_norm_rel": norm, "mu_rel": mu, "mu_worst_leaf": mu_leaf,
            "delta_rel": delta, "delta_worst_leaf": delta_leaf}


def check_train_agreement(agree: dict, floor: dict | None = None) -> None:
    """``agree`` within the ``SHARDED_*`` bounds, or, given the distance
    of two one-device runs that differ only in K2's rounding (``floor``),
    within ``SHARDED_MOE_FLOOR_FACTOR`` times it where that is larger."""
    for key, bound in (("grad_norm_rel", SHARDED_NORM_RTOL),
                       ("mu_rel", SHARDED_MU_RTOL),
                       ("delta_rel", SHARDED_DELTA_RTOL)):
        if floor is not None:
            bound = max(bound, SHARDED_MOE_FLOOR_FACTOR * floor[key])
        assert agree[key] <= bound, (key, agree, floor)


def _keeping(cls, box: dict):
    """``cls`` (a ``Program``) keeping its first step's summed gradients,
    before the clip, in ``box["grads"]``: {(leaf, region): tensor}."""
    class Keeping(cls):
        def _reduce(self, *args):
            out = super()._reduce(*args)
            if "grads" not in box:
                regions = self._leaf_regions
                box["grads"] = {(j, regions[j][i]): g for i, gl in
                                out.items() for j, g in enumerate(gl)}
            return out

    return Keeping


def sharded_train(dev, smi: str, spec=SHARDED_TRAIN,
                  control=_drop_row_grads, alloc_bound: bool = False,
                  keep: dict | None = None) -> dict:
    """h2o-danube-1.8b at full width and depth, bf16, AdamW, over a (data
    2, model 2) mesh of four logical devices on the card: global batch 4 x
    4,096 (``synthetic_batch``), ``SHARDED_TRAIN``'s steps, against the
    same steps on one logical device (``check_train_agreement``), and
    again with a planted fault (``control``: a ``Program`` subclass's
    factory, or None) that the same check must refuse.  ``spec``: another
    (arch, mesh, B, S, steps, layers kept or None).  ``alloc_bound``: one
    more sharded step under ``launch.costs.CostCounter``, whose largest
    allocated storage must not exceed one shard's f32 logits (B_local x S
    x V/m x 4 bytes: the vocabulary stays split).  A MoE config's first
    aux loss is held
    within ``MOE_AUX_RTOL`` of one device's, and its agreement within
    twice that of two one-device runs differing only in K2's rounding
    where that is larger than the bounds (a router's bf16 floor).
    ``keep``: filled with what ``sharded_fsdp`` holds its steps against
    (the one-device run, the batches, the first step's summed gradients,
    the step p50), which this run then does not free."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.spmd import Program
    from repro_torch.models import layer_specs, stacked_leaves
    from repro_torch.training import (DataConfig, TrainState, get_optimizer,
                                      make_train_step, synthetic_batch)
    from repro_torch.tree import named_leaves, tree_map

    arch, shape, B, S, steps, n_layers = spec
    cfg = get_config(arch)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    assert cfg.remat
    n_attn = sum(s.kind != "mamba" for s in layer_specs(cfg))
    pred = predicted(cfg, shape, B, S, "train", whole=False)
    mesh = _mesh_on(shape, dev)
    prog = (Program if keep is None else _keeping(Program, keep))(
        cfg, mesh, batch=B)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(
        cfg, DataConfig(batch=B, seq_len=S, seed=0), i).items()}
        for i in range(steps)]
    params = _seeded_params(cfg, dev, 0)
    # the untied head's rows N(0, 1/d) too, as the embedding's: N(0, 1)
    # rows make logits of scale sqrt(d) and a first loss near 200
    if "head" in params:
        params["head"]["table"].mul_(cfg.d_model ** -0.5)
    opt = get_optimizer("adamw", lr=SHARDED_LR, warmup_steps=1)
    # the same program on one logical device first: each step's loss and
    # gradient norm, the final params and first moment kept (the rest of
    # its state freed before the sharded run)
    one = tree_map(torch.clone, params)
    one = TrainState(one, opt.init(stacked_leaves(one, cfg)))
    one_step = make_train_step(cfg, opt)
    one_losses, one_norms, one_aux = [], [], []
    for b in batches:
        one, m = one_step(one, b)
        one_losses.append(float(m["loss"]))
        one_norms.append(float(m["grad_norm"]))
        one_aux.append(float(m["aux_loss"]))
    one = {"p0": dict(named_leaves(params)),
           "p": dict(named_leaves(one.params)),
           "mu": dict(named_leaves(one.opt_state.mu))}
    # held through the sharded steps for the checks (the peak counts them)
    kept = sum(t.numel() * t.element_size() for part in one.values()
               for t in part.values())
    del one_step, m
    gc.collect()
    torch.cuda.empty_cache()
    floor = None
    if cfg.n_experts:
        # a MoE router's bf16 floor: the same one-device steps with K2's
        # plain version in K2's place, against the first run
        alt = tree_map(torch.clone, params)
        alt = TrainState(alt, opt.init(stacked_leaves(alt, cfg)))
        alt_step, alt_norms = make_train_step(cfg, opt), []
        with swapped_routes(k2=cuda_routes()["plain"][0]):
            for b in batches:
                alt, m = alt_step(alt, b)
                alt_norms.append(float(m["grad_norm"]))
        floor = train_agreement(None, alt, one, alt_norms, one_norms)
        del alt, alt_step, m
        gc.collect()
        torch.cuda.empty_cache()
    state = prog.init_state(opt, prog.place_params(params))
    step = prog.train_step(opt)
    placed = [prog.place_batch(b) for b in batches]
    held = held_bytes((state, placed[0]))
    assert pred["args"] == held, (pred["args"], held)
    # the per-reduction check (one step), then the control (a forward)
    ulps: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with combine_checked(ulps):
        (state, m0), launches0 = _counted(lambda: step(state, placed[0]))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    rounded: list = []
    with torch.no_grad(), combine_checked(rounded, control=True):
        prog.forward(state.params, placed[0]["inputs"],
                     placed[0]["positions"], mode="train")
    torch.cuda.synchronize()
    losses, step_s, launches = [float(m0["loss"])], [], []
    norms, aux = [float(m0["grad_norm"])], [float(m0["aux_loss"])]
    for b in placed[1:]:
        ((state, m), n), dt = _timed(lambda: _counted(lambda: step(state, b)))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        aux.append(float(m["aux_loss"]))
        step_s.append(dt)
        launches.append(n)
    agree = train_agreement(prog, state, one, norms, one_norms)
    if keep is not None:
        keep["regions"] = prog._leaf_regions
    alloc = None
    if alloc_bound:
        from repro_torch.launch.costs import CostCounter

        counter = CostCounter()
        with counter:
            state, _ = step(state, placed[-1])
        torch.cuda.synchronize()
        rows = mesh.size // prog.m
        alloc = {"largest_bytes": counter.largest[0],
                 "largest_shape": list(counter.largest[1]),
                 "largest_shard": counter.largest[2],
                 "bound_bytes": (B // rows) * S * (cfg.vocab_size // prog.m)
                 * 4, "whole_logits_bytes": (B // rows) * S
                 * cfg.vocab_size * 4, "ops": counter.ops}
        del counter
    del state, step, prog
    gc.collect()
    torch.cuda.empty_cache()
    bad_agree = None
    if control is not None:
        # the planted control: the same steps with a fault (row 1's
        # gradients or the other vocabulary shards' loss terms dropped)
        bad = control()(cfg, mesh, batch=B)
        bad_state = bad.init_state(opt, bad.place_params(params))
        bad_step = bad.train_step(opt)
        bad_norms = []
        for b in placed:
            bad_state, m = bad_step(bad_state, b)
            bad_norms.append(float(m["grad_norm"]))
        bad_agree = train_agreement(bad, bad_state, one, bad_norms,
                                    one_norms)
        del bad_state, bad_step, bad
    if keep is not None:
        keep.update(spec=spec, one=one, one_norms=one_norms,
                    one_losses=one_losses, batches=batches,
                    step_p50_s=statistics.median(step_s))
    del params, one
    want = {"K2": 2 * n_attn * mesh.size, "K3": 0, "K4": 0}
    rel = max(abs(a - b) / b for a, b in zip(losses, one_losses))
    # the aux of the same params: the first step's (the later steps' params
    # part by AdamW's sign flips of near-zero bf16 gradients, which a MoE
    # router's balance follows far: reported)
    aux_rel = abs(aux[0] - one_aux[0]) / one_aux[0] if cfg.n_experts \
        else 0.0
    p50 = statistics.median(step_s)
    res = {"phase": "sharded", "program": "train_step", "arch": arch,
           "card": smi, "mesh": dict(mesh.shape), "B": B, "S": S,
           "reduced": (f"n_layers {get_config(arch).n_layers} -> "
                       f"{n_layers}" if n_layers else None),
           "optimizer": "adamw", "losses": losses,
           "aux_losses": aux, "one_device_aux_losses": one_aux,
           "aux_rel_diff_first_step": aux_rel,
           "lr": SHARDED_LR, "one_device_losses": one_losses,
           "loss_rel_diff": rel, "grad_norms": norms,
           "one_device_grad_norms": one_norms, "agreement": agree,
           "control_agreement": bad_agree, "one_device_floor": floor,
           "combine_max_ulps": max(ulps), "combines_checked": len(ulps),
           "control_max_ulps": max(rounded), "launches_per_step": want,
           "step_s": step_s, "step_p50_s": p50,
           "tokens_per_s": B * S / p50, "allocation": alloc,
           "control": control.__name__ if control else None,
           "bound_s": pred["bound_s"], "share_of_bound": pred["bound_s"] / p50,
           "held_bytes": held, "predicted_args_bytes": pred["args"],
           "predicted_args_per_device": pred["args_per_device"],
           "predicted_peak_bytes": pred["peak"],
           "measured_peak_bytes": peak, "allocated_before_step": base,
           "kept_for_checks_bytes": kept,
           "collective_bytes": pred["collective_bytes"],
           "flops_per_step": pred["flops"], "dryrun_trace_s":
           pred["trace_s"]}
    emit({"phase": "sharded_train_agreement", "arch": arch, "sound": agree,
          "control": bad_agree, "one_device_floor": floor})
    emit(res)
    assert launches0 == want and all(l == want for l in launches), (
        launches0, launches, want)
    assert max(ulps) <= MESH_COMBINE_ULPS, max(ulps)
    assert max(rounded) > MESH_COMBINE_ULPS, max(rounded)
    assert all(map(math.isfinite, losses)), losses
    assert rel <= SHARDED_LOSS_RTOL, (losses, one_losses)
    assert aux_rel <= MOE_AUX_RTOL, (aux, one_aux)
    check_train_agreement(agree, floor)
    if alloc is not None:
        assert alloc["largest_bytes"] <= alloc["bound_bytes"], alloc
    if control is not None:
        try:
            check_train_agreement(bad_agree)
        except AssertionError:
            pass
        else:
            raise AssertionError(
                f"the control passed the check: {bad_agree}")
    assert p50 >= pred["bound_s"], (p50, pred["bound_s"])
    del placed
    gc.collect()
    torch.cuda.empty_cache()
    return res


def sharded_fsdp(dev, smi: str, ref: dict) -> dict:
    """Params over 'data' on the card: h2o-danube-1.8b at full width and
    depth, bf16, AdamW, on (data 2, model 2) by ``make_rules(...,
    fsdp=True)`` (``embed`` over 'data': every leaf with an embed dim split
    over the rows too, gathered whole at each use), the steps of
    ``sharded_train``'s run ``ref`` (its spec and batches) from the same
    seeded state, held: each device's slice of the first step's summed
    gradients against the same region of that run's (expected bit-equal),
    the state after the steps against one device's
    (``check_train_agreement``), the placed bytes against the trace's.
    Then a prefill of ``SHARDED_FSDP``'s B x S and teacher-forced decode
    steps, against one device."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.sharding import make_rules
    from repro_torch.launch.spmd import Program
    from repro_torch.models import decode_step, layer_specs, prefill
    from repro_torch.training import get_optimizer

    arch, shape, B, S, _, _ = ref["spec"]
    cfg = get_config(arch)
    n_attn = sum(s.kind != "mamba" for s in layer_specs(cfg))
    pred = predicted(cfg, shape, B, S, "train", whole=False, fsdp=True)
    mesh = _mesh_on(shape, dev)
    box: dict = {}
    prog = _keeping(Program, box)(cfg, mesh, rules=make_rules(
        cfg, mesh, batch=B, fsdp=True))
    params = _seeded_params(cfg, dev, 0)
    params["head"]["table"].mul_(cfg.d_model ** -0.5)
    opt = get_optimizer("adamw", lr=SHARDED_LR, warmup_steps=1)
    state = prog.init_state(opt, place_freeing(prog, params))
    del params
    step = prog.train_step(opt)
    placed = [prog.place_batch(b) for b in ref["batches"]]
    held = held_bytes((state, placed[0]))
    assert pred["args"] == held, (pred["args"], held)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (state, m0), launches0 = _counted(lambda: step(state, placed[0]))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    # each device's slice of every summed gradient against the same region
    # of the step without fsdp
    worst, differ, n_slices = 0.0, 0, 0
    mine = prog._leaf_regions
    for (j, region), g in box.pop("grads").items():
        i = mine[j].index(region)
        base = ref["regions"][j][i]
        want = ref["grads"][(j, base)][tuple(
            slice(a - c, b - c) for (a, b), (c, _) in zip(region, base))]
        n_slices += 1
        if not bit_equal(g, want):
            differ += 1
            worst = max(worst, (g.float() - want.float()).abs().max().item())
    del ref["grads"]
    losses, norms = [float(m0["loss"])], [float(m0["grad_norm"])]
    step_s, launches = [], []
    for b in placed[1:]:
        ((state, m), n), dt = _timed(lambda: _counted(lambda: step(state, b)))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        step_s.append(dt)
        launches.append(n)
    agree = train_agreement(prog, state, ref["one"], norms, ref["one_norms"])
    del state, step, placed
    gc.collect()
    torch.cuda.empty_cache()
    want = {"K2": 2 * n_attn * mesh.size, "K3": 0, "K4": 0}
    rel = max(abs(a - b) / b for a, b in zip(losses, ref["one_losses"]))
    p50 = statistics.median(step_s)
    train = {"program": "train_step, params over data", "losses": losses,
             "one_device_losses": ref["one_losses"], "loss_rel_diff": rel,
             "grad_norms": norms, "agreement": agree,
             "grad_slices_compared": n_slices,
             "grad_slices_differing": differ,
             "grad_slice_max_abs_diff": worst,
             "launches_per_step": launches0, "step_s": step_s,
             "step_p50_s": p50, "step_p50_s_without_fsdp": ref["step_p50_s"],
             "bound_s": pred["bound_s"], "share_of_bound": pred["bound_s"]
             / p50, "held_bytes": held, "predicted_args_bytes": pred["args"],
             "predicted_args_per_device": pred["args_per_device"],
             "predicted_peak_bytes": pred["peak"],
             "measured_peak_bytes": peak,
             "collective_bytes": pred["collective_bytes"],
             "flops_per_step": pred["flops"],
             "dryrun_trace_s": pred["trace_s"]}
    emit({"phase": "sharded_fsdp_train", "arch": arch, "card": smi,
          "mesh": dict(mesh.shape), "B": B, "S": S, **train})
    assert launches0 == want and all(l == want for l in launches), (
        launches0, launches, want)
    assert all(map(math.isfinite, losses)), losses
    assert rel <= SHARDED_LOSS_RTOL, (losses, ref["one_losses"])
    check_train_agreement(agree)
    assert p50 >= pred["bound_s"], (p50, pred["bound_s"])
    del ref["one"]
    gc.collect()
    torch.cuda.empty_cache()

    # prefill and decode over the fsdp placement
    Bp, Sp, new = SHARDED_FSDP
    pre_pred = predicted(cfg, shape, Bp, Sp, "prefill", whole=False,
                         fsdp=True)
    dec_pred = predicted(cfg, shape, Bp, Sp + new, "decode", whole=False,
                         fsdp=True)
    prog = Program(cfg, mesh, rules=make_rules(cfg, mesh, batch=Bp,
                                               fsdp=True))
    params = _seeded_params(cfg, dev, 0)
    params["head"]["table"].mul_(cfg.d_model ** -0.5)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (Bp, Sp))
                            .astype(np.int32)).to(dev)
    pos = torch.arange(Sp, dtype=torch.int32, device=dev)[None].repeat(Bp, 1)
    with torch.no_grad():
        one, caches = prefill(params, toks, pos, cfg, max_len=Sp + new)
        placed = prog.place_params(params)
        pb = prog.place_batch({"inputs": toks, "positions": pos})
        pre_held = held_bytes((placed, pb))
        assert pre_pred["args"] == pre_held, (pre_pred["args"], pre_held)
        ((logits, split), l_pre), pre_s = _timed(lambda: _counted(
            lambda: prog.prefill(placed, pb["inputs"], pb["positions"],
                                 max_len=Sp + new)))
        errs = [logit_check(logits.gather(dev), one)]
        nxt = one.argmax(-1).to(torch.int32)
        dec_held = held_bytes((placed, split, prog.place_batch(
            {"inputs": nxt, "positions": pos[:, :1]})))
        assert dec_pred["args"] == dec_held, (dec_pred["args"], dec_held)
        dec_s, k4 = [], 0
        for i in range(new):
            p1 = torch.full((Bp, 1), Sp + i, dtype=torch.int32, device=dev)
            b = prog.place_batch({"inputs": nxt, "positions": p1})
            (got, n), dt = _timed(lambda: _counted(lambda: prog.decode_step(
                placed, split, b["inputs"], b["positions"])))
            one, caches = decode_step(params, caches, nxt, p1, cfg)
            dec_s.append(dt)
            k4 += n["K4"]
            errs.append(logit_check(got.gather(dev), one))
            nxt = one.argmax(-1).to(torch.int32)
    want_pre = {"K2": n_attn * mesh.size, "K3": 0, "K4": 0}
    serve = {"program": "prefill+decode_step, params over data", "B": Bp,
             "S": Sp, "decode_steps": new, "prefill_s": pre_s,
             "prefill_bound_s": pre_pred["bound_s"],
             "launches_prefill": l_pre, "k4_launches": k4,
             "decode_step_p50_s": statistics.median(dec_s),
             "decode_bound_s": dec_pred["bound_s"],
             "logit_err_over_scale": max(e[0] for e in errs),
             "greedy_sure": sum(e[1] for e in errs),
             "greedy_sure_agree": sum(e[2] for e in errs),
             "held_bytes_prefill": pre_held, "held_bytes_decode": dec_held,
             "collective_bytes_prefill": pre_pred["collective_bytes"],
             "collective_bytes_decode_step": dec_pred["collective_bytes"]}
    emit({"phase": "sharded_fsdp_serve", "arch": arch, "card": smi,
          "mesh": dict(mesh.shape), **serve})
    assert l_pre == want_pre, (l_pre, want_pre)
    assert k4 == n_attn * mesh.size * new, k4
    assert serve["logit_err_over_scale"] <= SHARDED_LOGIT_TOL, errs
    assert all(e[1] == e[2] for e in errs), errs
    assert pre_s >= pre_pred["bound_s"], (pre_s, pre_pred["bound_s"])
    assert serve["decode_step_p50_s"] >= dec_pred["bound_s"]
    del placed, split, params, caches
    gc.collect()
    torch.cuda.empty_cache()
    return {"train": train, "serve": serve}


def sharded_serve(dev, smi: str) -> dict:
    """zamba2-2.7b at full width and depth, bf16, over a (data 1, model 2)
    mesh of two logical devices on the card: a prefill of 2 x 4,096
    random tokens and 32 greedy ``decode_step``s, teacher-forced with the
    one-device program's tokens."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.spmd import Program
    from repro_torch.models import decode_step, layer_specs, prefill

    arch, shape, B, S, new = SHARDED_SERVE
    cfg = get_config(arch)
    kinds = [s.kind for s in layer_specs(cfg)]
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("shared_attn")
    pre_pred = predicted(cfg, shape, B, S, "prefill")
    dec_pred = predicted(cfg, shape, B, S + new, "decode")
    mesh = _mesh_on(shape, dev)
    prog = Program(cfg, mesh, batch=B)
    params = _seeded_params(cfg, dev, 0)
    placed = prog.place_params(params)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)).to(dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    pb = prog.place_batch({"inputs": toks, "positions": pos})
    held = held_bytes((placed, pb))
    assert pre_pred["args"] == held, (pre_pred["args"], held)
    run = lambda: prog.prefill(placed, pb["inputs"], pb["positions"],
                               max_len=S + new)
    ulps: list = []
    with torch.no_grad(), combine_checked(ulps):
        _, l_checked = _counted(run)
    control: list = []
    with torch.no_grad(), combine_checked(control, control=True):
        run()
    with torch.no_grad():
        ((logits, caches), l_pre), pre_s = _timed(lambda: _counted(run))
        one, one_caches = prefill(params, toks, pos, cfg, max_len=S + new)
    want = {"K2": n_attn * mesh.size, "K3": n_mamba * mesh.size, "K4": 0}
    assert l_checked == l_pre == want, (l_checked, l_pre, want)
    assert max(ulps) <= MESH_COMBINE_ULPS, max(ulps)
    assert max(control) > MESH_COMBINE_ULPS, max(control)
    assert pre_s >= pre_pred["bound_s"], (pre_s, pre_pred["bound_s"])

    compare = logit_check
    errs = [compare(logits.gather(dev), one)]
    nxt = one.argmax(-1).to(torch.int32)
    step_s, l_dec = [], {"K2": 0, "K3": 0, "K4": 0}
    dec_held = held_bytes((placed, caches, prog.place_batch(
        {"inputs": nxt, "positions": pos[:, :1]})))
    assert dec_pred["args"] == dec_held, (dec_pred["args"], dec_held)
    with torch.no_grad():
        for i in range(new):
            p1 = torch.full((B, 1), S + i, dtype=torch.int32, device=dev)
            b = prog.place_batch({"inputs": nxt, "positions": p1})
            (got, l), dt = _timed(lambda: _counted(lambda: prog.decode_step(
                placed, caches, b["inputs"], b["positions"])))
            one, one_caches = decode_step(params, one_caches, nxt, p1, cfg)
            step_s.append(dt)
            l_dec = {k: l_dec[k] + v for k, v in l.items()}
            errs.append(compare(got.gather(dev), one))
            nxt = one.argmax(-1).to(torch.int32)
    assert l_dec == {"K2": 0, "K3": 0, "K4": n_attn * mesh.size * new}, l_dec
    worst = max(e[0] for e in errs)
    assert worst <= SHARDED_LOGIT_TOL, errs
    assert all(e[1] == e[2] for e in errs), errs
    p50 = statistics.median(step_s)
    assert p50 >= dec_pred["bound_s"], (p50, dec_pred["bound_s"])
    res = {"phase": "sharded", "program": "prefill+decode_step",
           "arch": arch, "card": smi, "mesh": dict(mesh.shape), "B": B,
           "S": S, "decode_steps": new, "prefill_s": pre_s,
           "prefill_bound_s": pre_pred["bound_s"],
           "decode_step_p50_s": p50, "decode_bound_s": dec_pred["bound_s"],
           "launches_prefill": want, "launches_decode": l_dec,
           "combine_max_ulps": max(ulps), "combines_checked": len(ulps),
           "control_max_ulps": max(control),
           "logit_err_over_scale": worst,
           "greedy_sure": sum(e[1] for e in errs),
           "greedy_sure_agree": sum(e[2] for e in errs),
           "steps_within_bound": sum(int(e[0] <= SHARDED_LOGIT_TOL)
                                   for e in errs),
           "held_bytes_prefill": held, "held_bytes_decode": dec_held,
           "predicted_prefill_peak_bytes": pre_pred["peak"],
           "predicted_decode_peak_bytes": dec_pred["peak"],
           "collective_bytes_prefill": pre_pred["collective_bytes"],
           "collective_bytes_decode_step": dec_pred["collective_bytes"],
           "dryrun_trace_s": pre_pred["trace_s"] + dec_pred["trace_s"]}
    emit(res)
    del placed, caches, params, one_caches
    gc.collect()
    torch.cuda.empty_cache()
    return res


def logit_check(got, ref) -> tuple[float, int, int]:
    """(largest |diff| over the one-device logits' scale, the greedy tokens
    that must agree (the one-device top-two margin above twice
    ``SHARDED_LOGIT_TOL`` of the scale), and those that do)."""
    got, ref = got.float(), ref.float()
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item() / scale
    top2 = ref.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * SHARDED_LOGIT_TOL * scale
    same = got.argmax(-1) == ref.argmax(-1)
    return err, int(sure.sum()), int((same & sure).sum())


def cache_distance(got, want) -> dict:
    """Each leaf of two placed cache trees shard by shard: positions
    (int) must be equal; the largest |diff| of a float leaf over its
    largest magnitude, the worst leaf's reported."""
    from repro_torch.tree import named_leaves, tree_leaves

    worst, leaf = 0.0, None
    for (name, a), b in zip(named_leaves(got), tree_leaves(want)):
        assert a.placement.spec == b.placement.spec and a.shape == b.shape
        for x, y in zip(a.shards, b.shards):
            assert x.shape == y.shape, name
            if not x.is_floating_point():
                assert torch.equal(x, y), name
                continue
            d = ((x.float() - y.float()).abs().max()
                 / torch.clamp(y.float().abs().max(), min=1e-30)).item()
            if d > worst:
                worst, leaf = d, name
    return {"cache_err_over_scale": worst, "cache_worst_leaf": leaf}


def sharded_seq_run(dev, smi: str, shape, B: int, **rules) -> dict:
    """Stage 4 on the card: h2o-danube-1.8b at full width and depth, bf16,
    B distinct prompts of ``SHARDED_SEQ``'s length over ``shape``, the
    sequence of its caches (rings of 4,096 slots) split over 'data' (at B
    1 by the rules; else ``seq_shard_cache``, the caches' batch split over
    what is left of the batch axes): ``Program.prefill`` builds them split
    (each distinct batch row's program, each device keeping its part),
    held against the one-device prefill (logits; each cache leaf against
    ``place_caches`` of the one-device caches); then greedy decode steps
    over them, each batch region's rows in lockstep over its batch, each
    part of a cache attended through K4 with its log-sum-exp and the parts
    merged, teacher-forced with the one-device program's tokens."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.sharding import make_rules
    from repro_torch.launch.spmd import Program
    from repro_torch.models import decode_step, layer_specs, prefill

    arch, _, S, new = SHARDED_SEQ
    cfg = get_config(arch)
    n_attn = sum(s.kind != "mamba" for s in layer_specs(cfg))
    pre_pred = predicted(cfg, shape, B, S, "prefill", whole=False, **rules)
    pred = predicted(cfg, shape, B, S + new, "decode", whole=False, **rules)
    mesh = _mesh_on(shape, dev)
    prog = Program(cfg, mesh, rules=make_rules(cfg, mesh, batch=B, **rules))
    assert all(len(g[2]) == shape[-2] for g in prog.seq_groups), \
        prog.seq_groups
    params = _seeded_params(cfg, dev, 0)
    params["head"]["table"].mul_(cfg.d_model ** -0.5)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)).to(dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    with torch.no_grad():
        one, caches = prefill(params, toks, pos, cfg, max_len=S + new)
        placed = prog.place_params(params)
        pb = prog.place_batch({"inputs": toks, "positions": pos})
        pre_held = held_bytes((placed, pb))
        assert pre_pred["args"] == pre_held, (pre_pred["args"], pre_held)
        ((logits, split), l_pre), pre_s = _timed(lambda: _counted(
            lambda: prog.prefill(placed, pb["inputs"], pb["positions"],
                                 max_len=S + new)))
        pre_err = logit_check(logits.gather(dev), one)
        dist = cache_distance(split, prog.place_caches(caches))
        nxt = one.argmax(-1).to(torch.int32)
        held = held_bytes((placed, split, prog.place_batch(
            {"inputs": nxt, "positions": pos[:, :1]})))
        assert pred["args"] == held, (pred["args"], held)
        errs, step_s, k4 = [pre_err], [], 0
        for i in range(new):
            p1 = torch.full((B, 1), S + i, dtype=torch.int32, device=dev)
            b = prog.place_batch({"inputs": nxt, "positions": p1})
            (got, n), dt = _timed(lambda: _counted(lambda: prog.decode_step(
                placed, split, b["inputs"], b["positions"])))
            one, caches = decode_step(params, caches, nxt, p1, cfg)
            step_s.append(dt)
            k4 += n["K4"]
            errs.append(logit_check(got.gather(dev), one))
            nxt = one.argmax(-1).to(torch.int32)
    # K2: each distinct batch row's program over its shards; K4: each
    # region's program over its shards, one launch a part
    rows = mesh.size // shape[-1]
    distinct = min(B, rows)
    want_pre = {"K2": n_attn * shape[-1] * distinct, "K3": 0, "K4": 0}
    want_k4 = n_attn * mesh.size * new
    worst = max(e[0] for e in errs)
    p50 = statistics.median(step_s)
    res = {"phase": "sharded", "program": "prefill + decode_step, "
           "sequence split", "arch": arch, "card": smi,
           "mesh": dict(mesh.shape), "B": B, "prompt": S,
           "rules": rules or None, "cache_pos_spec": list(
               prog.cache_placements()[0]["pos"].spec),
           "seq_groups": [g[2] for g in prog.seq_groups],
           "decode_steps": new, "prefill_s": pre_s,
           "prefill_bound_s": pre_pred["bound_s"], "launches_prefill": l_pre,
           "prefill_logit_err_over_scale": pre_err[0], **dist,
           "k4_launches": k4, "k4_per_step": k4 // new,
           "decode_step_p50_s": p50, "decode_bound_s": pred["bound_s"],
           "logit_err_over_scale": worst,
           "greedy_sure": sum(e[1] for e in errs),
           "greedy_sure_agree": sum(e[2] for e in errs),
           "held_bytes_prefill": pre_held, "held_bytes": held,
           "predicted_prefill_peak_bytes": pre_pred["peak"],
           "predicted_peak_bytes": pred["peak"],
           "collective_bytes_prefill": pre_pred["collective_bytes"],
           "collective_bytes_step": pred["collective_bytes"]}
    emit(res)
    assert l_pre == want_pre, (l_pre, want_pre)
    assert dist["cache_err_over_scale"] <= SHARDED_LOGIT_TOL, dist
    assert k4 == want_k4, (k4, want_k4)
    assert worst <= SHARDED_LOGIT_TOL, errs
    assert all(e[1] == e[2] for e in errs), errs
    assert pre_s >= pre_pred["bound_s"], (pre_s, pre_pred["bound_s"])
    assert p50 >= pred["bound_s"], (p50, pred["bound_s"])
    del placed, split, params, caches
    gc.collect()
    torch.cuda.empty_cache()
    return res


def sharded_seq(dev, smi: str) -> dict:
    """``sharded_seq_run`` at batch 1 on (data 2, model 2), then over
    caches split over both the batch and the sequence
    (``SHARDED_SEQ_BATCHES``)."""
    out = {"B1": sharded_seq_run(dev, smi, SHARDED_SEQ[1], 1)}
    for shape, B in SHARDED_SEQ_BATCHES:
        out[f"B{B}"] = sharded_seq_run(dev, smi, shape, B,
                                       seq_shard_cache=True)
    return out


@contextlib.contextmanager
def moe_routes(out: dict, inputs: bool = False):
    """Inside the block, each MoE layer's routing as the one device, or
    shard 0 of each row, computes it, in call order: its (n, k) expert ids
    to ``out["idx"]``, its tokens' top k + 1 router probabilities to
    ``out["top"]``, its entries' (n, k) fit in capacity to ``out["keep"]``
    (``models/moe.py``'s ``route`` and ``dispatch_plan`` spied on);
    ``inputs``: its router inputs too, to ``out["x"]`` (on the host)."""
    import importlib

    from repro_torch.core.sharded import current_shard

    moe_mod = importlib.import_module("repro_torch.models.moe")
    route, plan = moe_mod.route, moe_mod.dispatch_plan
    for key in ("idx", "top", "keep") + (("x",) if inputs else ()):
        out.setdefault(key, [])

    def spy_route(params, x_flat, cfg):
        res = route(params, x_flat, cfg)
        if current_shard() in (None, 0):
            with torch.no_grad():
                out["top"].append(torch.topk(res[2], cfg.top_k + 1,
                                             dim=-1).values)
                if inputs:
                    out["x"].append(x_flat.detach().float().cpu())
            out["idx"].append(res[1].detach().clone())
        return res

    def spy_plan(*a, **kw):
        res = plan(*a, **kw)
        if current_shard() in (None, 0):
            out["keep"].append(res.keep.clone())
        return res

    moe_mod.route, moe_mod.dispatch_plan = spy_route, spy_plan
    try:
        yield out
    finally:
        moe_mod.route, moe_mod.dispatch_plan = route, plan


def routes_by_layer(rec: dict, rows: int) -> dict:
    """A run's routing records per MoE layer, the rows' records (the rows
    run each layer in lockstep, in token order) concatenated, on the
    host."""
    out = {}
    for key, ts in rec.items():
        n = len(ts) // rows
        out[key] = [torch.cat([ts[li * rows + r] for r in range(rows)]).cpu()
                    for li in range(n)]
    return out


def route_diffs(a: dict, b: dict) -> dict:
    """Per MoE layer, the tokens of run ``a`` whose experts differ from run
    ``b``'s as a set (``sets``) and those whose slot order alone differs
    (``orders``); and of all those tokens, the ones whose top k + 1 router
    probabilities in ``b`` hold no near-tie (``untied``, which no
    difference of rounding explains) and their smallest relative gap."""
    sets, orders, untied, gap = [], [], 0, None
    for x, y, top in zip(a["idx"], b["idx"], b["top"]):
        differ = (x != y).any(-1)
        by_set = (x.sort(-1).values != y.sort(-1).values).any(-1)
        sets.append(int(by_set.sum()))
        orders.append(int((differ & ~by_set).sum()))
        if differ.any():
            t = top[differ]
            g = ((t[:, :-1] - t[:, 1:]) / t[:, :-1]).amin(-1)
            untied += int((g >= MOE_TIE_RTOL).sum())
            gap = max(gap or 0.0, float(g.max()))
    return {"sets": sets, "orders": orders, "untied": untied,
            "largest_gap_of_a_difference": gap}


def place_freeing(prog, params):
    """``prog.place_params(params)`` leaf by leaf, each tensor dropped from
    ``params`` once placed: the one-device tree empties as its placement
    grows, so the card never holds both whole (deepseek-moe-16b: 32.8 GB
    and 35.6 GB placed)."""
    from repro_torch.core.sharded import place
    from repro_torch.tree import tree_leaves

    pls = iter(tree_leaves(prog.param_placements))

    def walk(node):
        keys = sorted(node) if isinstance(node, dict) else range(len(node))
        for k in keys:
            if isinstance(node[k], (dict, list)):
                walk(node[k])
            else:
                t, node[k] = node[k], None
                node[k] = place(t, prog.mesh, next(pls).spec)
                del t

    walk(params)
    return params


@contextlib.contextmanager
def expert_slots(out: list):
    """Inside the block, the buffer slots of each expert product
    (``models/moe.py``'s ``_expert_ffn``: experts x rows), in call
    order."""
    import importlib

    moe_mod = importlib.import_module("repro_torch.models.moe")
    ffn = moe_mod._expert_ffn

    def spy(params, xe):
        out.append(xe.shape[0] * xe.shape[1])
        return ffn(params, xe)

    moe_mod._expert_ffn = spy
    try:
        yield out
    finally:
        moe_mod._expert_ffn = ffn


def moe_serve_run(prog, params, toks, pos, toks2, pos2, new: int,
                  feed: list, cfg=None) -> dict:
    """prefill(toks), ``new`` greedy decode steps fed ``feed`` (or the
    run's own greedy tokens, ``feed`` then filled), prefill(toks2); one
    device (``prog`` None) or over ``prog``'s mesh, no grad.  The logits
    and both prefills' routing (``moe_routes``) on the host; over the mesh
    also each program's seconds and launches."""
    from repro_torch.models import decode_step, prefill

    B, S = toks.shape
    cfg = prog.cfg if prog is not None else cfg
    rows = prog.n_rows if prog is not None else 1
    res = {"decode": [], "decode_s": [], "decode_launches": []}
    with torch.no_grad():
        rec: dict = {}
        if prog is None:
            with moe_routes(rec):
                logits, caches = prefill(params, toks, pos, cfg,
                                         max_len=S + new)
        else:
            pb = prog.place_batch({"inputs": toks, "positions": pos})
            run = lambda: prog.prefill(params, pb["inputs"],
                                       pb["positions"], max_len=S + new)
            with moe_routes(rec):
                ((logits, caches), res["prefill_launches"]), \
                    res["prefill_s"] = _timed(lambda: _counted(run))
            res["held_prefill"] = held_bytes((params, pb))
            logits = logits.gather(toks.device)
        res["prefill"] = logits.cpu()
        res["routes"] = routes_by_layer(rec, rows)
        for i in range(new):
            if len(feed) <= i:
                feed.append(logits.argmax(-1).to(torch.int32))
            nxt = feed[i].to(toks.device)
            p1 = torch.full((B, 1), S + i, dtype=torch.int32,
                            device=toks.device)
            if prog is None:
                logits, caches = decode_step(params, caches, nxt, p1, cfg)
            else:
                b = prog.place_batch({"inputs": nxt, "positions": p1})
                if i == 0:
                    res["held_decode"] = held_bytes((params, caches, b))
                    res["slots"] = []
                with (expert_slots(res["slots"]) if i == 0
                      else contextlib.nullcontext()):
                    (got, n), dt = _timed(lambda: _counted(
                        lambda: prog.decode_step(params, caches,
                                                 b["inputs"],
                                                 b["positions"])))
                logits = got.gather(toks.device)
                res["decode_s"].append(dt)
                res["decode_launches"].append(n)
            res["decode"].append(logits.cpu())
        del caches
        rec2: dict = {}
        with moe_routes(rec2, inputs=True):
            if prog is None:
                logits, _ = prefill(params, toks2, pos2, cfg,
                                    max_len=toks2.shape[1])
            else:
                b2 = prog.place_batch({"inputs": toks2, "positions": pos2})
                logits, _ = prog.prefill(params, b2["inputs"],
                                         b2["positions"],
                                         max_len=toks2.shape[1])
                logits = logits.gather(toks.device)
        res["prefill2"] = logits.cpu()
        res["routes2"] = routes_by_layer(rec2, rows)
    return res


def moe_compare(sh: dict, one: dict, tol: float) -> dict:
    """The sharded run against one device's: each program's logits
    (``logit_check`` against ``tol``), the routing choices that differ per
    MoE layer, and the second prefill's dropped shares."""
    logits = [("prefill", sh["prefill"], one["prefill"])] + [
        (f"decode {i}", a, b) for i, (a, b) in enumerate(
            zip(sh["decode"], one["decode"]))] + [
        ("prefill2", sh["prefill2"], one["prefill2"])]
    errs = []
    for name, a, b in logits:
        a, b = a.float(), b.float()
        scale = b.abs().max().item()
        top2 = b.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * tol * scale
        same = a.argmax(-1) == b.argmax(-1)
        errs.append((name, (a - b).abs().max().item() / scale,
                     int(sure.sum()), int((same & sure).sum())))
    drop = lambda r: float(torch.stack([~k for k in r["keep"]]).float()
                           .mean())
    # how far the two runs' MoE inputs lie apart, layer by layer
    hidden = [float(torch.linalg.vector_norm(a - b)
                    / torch.linalg.vector_norm(b))
              for a, b in zip(sh["routes2"]["x"], one["routes2"]["x"])]
    return {"logit_errs": errs,
            "worst": max(e[1] for e in errs),
            "greedy_sure": sum(e[2] for e in errs),
            "greedy_sure_agree": sum(e[3] for e in errs),
            "route_diffs_prefill": route_diffs(sh["routes"], one["routes"]),
            "route_diffs_prefill2": route_diffs(sh["routes2"],
                                                one["routes2"]),
            "entries_per_layer": int(one["routes"]["idx"][0].numel()),
            "entries_per_layer2": int(one["routes2"]["idx"][0].numel()),
            "hidden_rel_per_layer2": hidden,
            "dropped_share2": drop(sh["routes2"]),
            "one_device_dropped_share2": drop(one["routes2"]),
            "keep2_equal": all(torch.equal(a, b) for a, b in zip(
                sh["routes2"]["keep"], one["routes2"]["keep"]))}


def bf16_floor(cfg, params, toks2, pos2, one: dict) -> dict:
    """How far two one-device bf16 runs lie apart that differ only in the
    rounding of their attention: the second prefill again with K2's plain
    version in its place, against ``one``'s (its logits over the scale,
    its MoE inputs layer by layer, its routing)."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import attention, prefill

    kernel_fn = attention.fa_ops.flash_attention

    def plain_fn(q, k, v, *, positions=None, **kw):
        return fa_ref.attention_ref(q, k, v, **kw)

    rec: dict = {}
    attention.fa_ops.flash_attention = plain_fn
    try:
        with torch.no_grad(), moe_routes(rec, inputs=True):
            logits, _ = prefill(params, toks2, pos2, cfg,
                                max_len=toks2.shape[1])
    finally:
        attention.fa_ops.flash_attention = kernel_fn
    alt = routes_by_layer(rec, 1)
    b = one["prefill2"].float()
    return {"logit_err_over_scale": float((logits.cpu() - b).abs().max()
                                          / b.abs().max()),
            "hidden_rel_per_layer": [
                float(torch.linalg.vector_norm(x - y)
                      / torch.linalg.vector_norm(y))
                for x, y in zip(alt["x"], one["routes2"]["x"])],
            "route_diffs": route_diffs(alt, one["routes2"])}


def moe_f32_check(cfg, params, mesh, dev, toks, pos, toks2, pos2) -> dict:
    """The first ``SHARDED_MOE_F32`` layers of the same weights upcast to
    f32, one device against the mesh: every routing choice equal, the
    logits within ``SHARDED_MOE_F32_TOL`` of the one-device scale, the
    second prefill's drops equal."""
    from repro_torch.launch.spmd import Program
    from repro_torch.tree import tree_map

    n_layers, S, new = SHARDED_MOE_F32
    c32 = cfg.replace(n_layers=n_layers, dtype="float32")
    cut = {k: v for k, v in params.items() if k != "layers"}
    cut["layers"] = params["layers"][:n_layers]
    p32 = tree_map(lambda t: t.float(), cut)
    toks, pos = toks[:, :S].contiguous(), pos[:, :S].contiguous()
    feed: list = []
    one = moe_serve_run(None, p32, toks, pos, toks2, pos2, new, feed, c32)
    prog = Program(c32, mesh, batch=toks.shape[0])
    placed = place_freeing(prog, p32)
    sh = moe_serve_run(prog, placed, toks, pos, toks2, pos2, new, feed)
    cmp = moe_compare(sh, one, SHARDED_MOE_F32_TOL)
    del placed, p32, prog
    gc.collect()
    torch.cuda.empty_cache()
    assert cmp["worst"] <= SHARDED_MOE_F32_TOL, cmp["logit_errs"]
    # every routing choice equal, but where one device's probabilities tie
    diffs = (cmp["route_diffs_prefill"], cmp["route_diffs_prefill2"])
    assert not any(d["untied"] for d in diffs), diffs
    assert cmp["keep2_equal"] or any(diffs[1]["sets"] + diffs[1]["orders"]
                                     ), cmp
    return {"reduced": f"n_layers {cfg.n_layers} -> {n_layers}, f32",
            "prompt": S, "decode_steps": new, **cmp}


def sharded_moe_serve(dev, smi: str) -> dict:
    """deepseek-moe-16b at full width and depth (28 layers, 27 MoE: 64
    experts top-6, 2 shared; bf16) with its experts over 'data' on a (data
    2, model 2) mesh of four logical devices on the card: a prefill of 4 x
    2,048 (groups of 512 inside the rows), 16 decode steps (each one group
    of 4 tokens over both rows) and a prefill of 4 x 120 (one group of 480
    over both rows, capacity 57: drops), teacher-forced with the
    one-device program's tokens.  The one-device program runs first and
    keeps its logits and routing on the host; its params are then placed
    leaf by leaf (``place_freeing``).  Before that, the first 4 layers in
    f32 (``moe_f32_check``: the logits held), and the bf16 drift between
    two one-device runs (``bf16_floor``), within whose envelope the
    sharded run's MoE inputs are held (``SHARDED_MOE_FLOOR_FACTOR``).
    Each owner device's expert products in a decode step are counted
    (``expert_slots``): one a MoE layer, over its experts and the step's
    one group's capacity."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.spmd import Program
    from repro_torch.models import layer_specs

    arch, shape, B, S, new, S2 = SHARDED_MOE
    cfg = get_config(arch)
    pre_pred = predicted(cfg, shape, B, S, "prefill", whole=False)
    dec_pred = predicted(cfg, shape, B, S + new, "decode", whole=False)
    mesh = _mesh_on(shape, dev)
    params = _seeded_params(cfg, dev, 0)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)).to(dev)
    toks2 = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S2)).astype(
        np.int32)).to(dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    pos2 = pos[:, :S2].contiguous()
    feed: list = []
    one = moe_serve_run(None, params, toks, pos, toks2, pos2, new, feed, cfg)
    floor = bf16_floor(cfg, params, toks2, pos2, one)
    f32 = moe_f32_check(cfg, params, mesh, dev, toks, pos, toks2, pos2)
    emit({"phase": "sharded_moe_f32", "arch": arch, "card": smi, **f32})
    prog = Program(cfg, mesh, batch=B)
    placed = place_freeing(prog, params)
    del params
    gc.collect()
    # the per-reduction check (a prefill), then its control
    pb = prog.place_batch({"inputs": toks, "positions": pos})
    run = lambda: prog.prefill(placed, pb["inputs"], pb["positions"],
                               max_len=S + new)
    ulps: list = []
    with torch.no_grad(), combine_checked(ulps):
        run()
    control: list = []
    with torch.no_grad(), combine_checked(control, control=True):
        run()
    del pb
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sh = moe_serve_run(prog, placed, toks, pos, toks2, pos2, new, feed)
    peak = torch.cuda.max_memory_allocated()
    cmp = moe_compare(sh, one, SHARDED_LOGIT_TOL)
    # F17: each owner device runs a decode step's one group (B tokens over
    # both rows) once a MoE layer, over its experts and the group's slots
    from repro_torch.models.moe import capacity

    n_moe = sum(s.kind == "attn_moe" for s in layer_specs(cfg))
    e = cfg.n_experts // len(prog.owners[0])
    slots = {"per_owner_per_layer": sorted(set(sh["slots"])),
             "products_per_step": len(sh["slots"]),
             "predicted_per_owner_per_layer": e * capacity(B, cfg),
             "one_row_at_a_time_per_owner_per_layer":
                 prog.n_rows * e * capacity(B, cfg)}
    want_pre = {"K2": cfg.n_layers * mesh.size, "K3": 0, "K4": 0}
    want_dec = {"K2": 0, "K3": 0, "K4": cfg.n_layers * mesh.size}
    p50 = statistics.median(sh["decode_s"])
    res = {"phase": "sharded", "program": "prefill+decode_step, experts "
           "over data", "arch": arch, "card": smi, "mesh": dict(mesh.shape),
           "B": B, "S": S, "decode_steps": new, "S2": S2,
           "prefill_s": sh["prefill_s"], "prefill_bound_s":
           pre_pred["bound_s"], "decode_step_p50_s": p50,
           "decode_bound_s": dec_pred["bound_s"],
           "launches_prefill": want_pre,
           "launches_decode": {"K4": want_dec["K4"] * new},
           "combine_max_ulps": max(ulps), "combines_checked": len(ulps),
           "control_max_ulps": max(control),
           "logit_err_over_scale": cmp["worst"],
           "logit_errs": cmp["logit_errs"],
           "hidden_rel_per_layer_480": cmp["hidden_rel_per_layer2"],
           "floor": floor,
           "greedy_sure": cmp["greedy_sure"],
           "greedy_sure_agree": cmp["greedy_sure_agree"],
           "route_diffs_per_layer_prefill": cmp["route_diffs_prefill"],
           "route_diffs_per_layer_prefill2": cmp["route_diffs_prefill2"],
           "route_entries_per_layer": cmp["entries_per_layer"],
           "dropped_share_480": cmp["dropped_share2"],
           "one_device_dropped_share_480": cmp["one_device_dropped_share2"],
           "keep_480_equal": cmp["keep2_equal"], "expert_slots": slots,
           "held_bytes_prefill": sh["held_prefill"],
           "held_bytes_decode": sh["held_decode"],
           "predicted_prefill_peak_bytes": pre_pred["peak"],
           "predicted_decode_peak_bytes": dec_pred["peak"],
           "measured_peak_bytes": peak,
           "collective_bytes_prefill": pre_pred["collective_bytes"],
           "collective_bytes_decode_step": dec_pred["collective_bytes"],
           "dryrun_trace_s": pre_pred["trace_s"] + dec_pred["trace_s"],
           "f32": {k: f32[k] for k in ("worst", "route_diffs_prefill",
                                       "route_diffs_prefill2",
                                       "dropped_share2", "keep2_equal")}}
    emit(res)
    assert sh["slots"] == [slots["predicted_per_owner_per_layer"]] * (
        n_moe * mesh.size), slots
    assert sh["prefill_launches"] == want_pre, sh["prefill_launches"]
    assert all(n == want_dec for n in sh["decode_launches"]), \
        sh["decode_launches"]
    assert pre_pred["args"] == sh["held_prefill"], (pre_pred["args"],
                                                     sh["held_prefill"])
    assert dec_pred["args"] == sh["held_decode"], (dec_pred["args"],
                                                    sh["held_decode"])
    assert max(ulps) <= MESH_COMBINE_ULPS, max(ulps)
    assert max(control) > MESH_COMBINE_ULPS, max(control)
    assert sh["prefill_s"] >= pre_pred["bound_s"], (sh["prefill_s"],
                                                    pre_pred["bound_s"])
    assert p50 >= dec_pred["bound_s"], (p50, dec_pred["bound_s"])
    drift = cmp["hidden_rel_per_layer2"]
    assert all(d <= SHARDED_MOE_FLOOR_FACTOR * f + SHARDED_LOGIT_TOL
               for d, f in zip(drift, floor["hidden_rel_per_layer"])), (
        drift, floor["hidden_rel_per_layer"])
    assert all(torch.isfinite(t).all() for t in
               [sh["prefill"], sh["prefill2"]] + sh["decode"])
    assert sh["prefill"].shape == (B, cfg.vocab_size)
    del placed, sh, one
    gc.collect()
    torch.cuda.empty_cache()
    return res


def sharded_moe(dev, smi: str) -> dict:
    """Stage 5 on the card: deepseek-moe-16b served (``sharded_moe_serve``)
    and trained (``SHARDED_MOE_TRAIN``, cut to 3 layers, against the
    one-device steps) with its experts over 'data'."""
    serve = sharded_moe_serve(dev, smi)
    train = sharded_train(dev, smi, SHARDED_MOE_TRAIN, control=None)
    return {"serve": serve, "train": train}


def sharded_phase(dev, smi: str) -> dict:
    """The sharded train step (danube on (2, 2), then with its params over
    'data'; gemma2-9b's split head and loss on (1, 2)), the sharded
    prefill and decode (zamba2 on (1, 2)), prefills and decodes over
    caches split over the sequence (danube at batch 1 on (2, 2), and over
    both the batch and the sequence at batches 2 and 4), and the experts
    over 'data' (deepseek-moe-16b on (2, 2)); the peaks reported, not
    asserted."""
    torch.cuda.reset_peak_memory_stats()
    keep: dict = {}
    train = sharded_train(dev, smi, keep=keep)
    fsdp = sharded_fsdp(dev, smi, keep)
    del keep
    vocab = sharded_train(dev, smi, SHARDED_VOCAB,
                          control=_drop_vocab_shards, alloc_bound=True)
    serve = sharded_serve(dev, smi)
    seq = sharded_seq(dev, smi)
    moe = sharded_moe(dev, smi)
    return {"train": train, "fsdp": fsdp, "vocab": vocab, "serve": serve,
            "seq": seq, "moe": moe,
            "launches": {"K2": {"train_step": train["launches_per_step"]["K2"],
                                "train_step_fsdp":
                                    fsdp["train"]["launches_per_step"]["K2"],
                                "train_step_split_vocab":
                                    vocab["launches_per_step"]["K2"],
                                "prefill": serve["launches_prefill"]["K2"],
                                "prefill_fsdp":
                                    fsdp["serve"]["launches_prefill"]["K2"],
                                **{f"prefill_sequence_split_{k}":
                                   v["launches_prefill"]["K2"]
                                   for k, v in seq.items()}},
                         "K3": {"prefill": serve["launches_prefill"]["K3"]},
                         "K4": {"decode": serve["launches_decode"]["K4"],
                                "decode_fsdp": fsdp["serve"]["k4_launches"],
                                **{f"decode_sequence_split_{k}":
                                   v["k4_launches"]
                                   for k, v in seq.items()}}},
            "launches_moe": {
                "K2": {"prefill": moe["serve"]["launches_prefill"]["K2"],
                       "train_step":
                           moe["train"]["launches_per_step"]["K2"]},
                "K4": {"decode": moe["serve"]["launches_decode"]["K4"]}}}


def dryrun_phase(smi: str) -> dict:
    """``python -m repro_torch.launch.dryrun --all`` (single-pod, every
    cell, ``DRYRUN_JOBS`` at once) in a subprocess on the card's host: one
    line per cell; every cell wrote its JSON (none may be uncovered)."""
    import re

    from repro_torch.configs.registry import all_cells
    from repro_torch.kernels import build
    from repro_torch.launch.dryrun import cell_file

    out = build.BUILD_DIR / "dryrun"
    if out.exists():
        for p in out.glob("*.json"):
            p.unlink()
    # one thread a cell: a trace on meta is Python, one core each
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--all", "--jobs", str(DRYRUN_JOBS), "--out",
                        str(out)], capture_output=True, text=True,
                       timeout=DRYRUN_TIMEOUT_S, env=env)
    seconds = time.monotonic() - t0
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    uncovered = dict(re.findall(r"^--- (\S+) mp=False: (.*)$", r.stdout,
                                re.M))
    cells = [c for c in all_cells() if not c.skipped]
    rows = []
    for c in cells:
        if c.name in uncovered:
            stage = re.search(r"Stage [0-9]+", uncovered[c.name])
            assert stage, uncovered[c.name]
            rows.append({"cell": c.name, "uncovered": stage.group(0)})
        else:
            res = json.loads((out / cell_file(c.arch_id, c.shape.name,
                                              multi_pod=False)).read_text())
            ro, ma = res["roofline"], res["memory_analysis"]
            rows.append({"cell": c.name,
                         "argument_bytes": ma["argument_bytes"],
                         "temp_bytes": ma["temp_bytes"],
                         "flops": res["cost_analysis"]["flops"],
                         "bytes_accessed": res["cost_analysis"][
                             "bytes_accessed"],
                         "collective_bytes": sum(
                             res["collective_bytes"].values()),
                         "compute_s": ro["compute_s"],
                         "memory_s": ro["memory_s"],
                         "collective_s": ro["collective_s"],
                         "dominant": ro["dominant"], "fits": res["fits"],
                         "trace_s": res["seconds"]["compile"]})
        emit({"phase": "dryrun_cell", **rows[-1]})
    res = {"phase": "dryrun", "card_host": smi, "seconds": seconds,
           "jobs": DRYRUN_JOBS, "cells": len(cells),
           "covered": sum("uncovered" not in r for r in rows),
           "uncovered": {r["cell"]: r["uncovered"] for r in rows
                         if "uncovered" in r}}
    res["over_80gb"] = [r["cell"] for r in rows if not r.get("fits", True)]
    emit(res)
    assert not res["uncovered"], res["uncovered"]
    assert not res["over_80gb"], res["over_80gb"]
    return res


# =============================================================== examples
EXAMPLES_DIR = Path(__file__).resolve().parent / "examples_torch"
# the twins of examples/*.py, in the order they run
EXAMPLES = ("quickstart", "smart_farming", "collision_detection", "serve_lm",
            "serve_cluster", "train_lm")
# the kernels each twin's path runs, which it must launch
EXAMPLE_KERNELS = {"serve_lm": ("ragged_paged_attention",),
                   "serve_cluster": ("ragged_paged_attention", "ssd"),
                   "train_lm": ("flash_attention",)}
EXAMPLES_BUDGET_S = 120.0
# K1 at the light tier's tick (gemma2-9b SMOKE: H 4, K 2, D 16, f32 pool,
# blocks of 16, 4 slots of 64, a 32-lane budget): a prefill chunk, decode
# rows and a row three tokens into its prompt, as (ctx, fed)
EXAMPLE_K1_ROWS = [(11, 11), (40, 1), (64, 1), (20, 3)]
EXAMPLE_K1 = ("gemma2-9b SMOKE", 4, 2, 16, 32)          # arch, H, K, D, T
# K2 at train_lm's lm100m (B 8 x S 256, H 8, K 4, D 64, f32, causal)
EXAMPLE_K2 = ("lm100m", 8, 256, 8, 4, 64, torch.float32, None, None)
# K3 at the heavy tier's prefills (mamba2-1.3b SMOKE: H 8, P 16, N 16,
# chunk 8, f32): one 11-token prompt and a batch of four 8-token ones
EXAMPLE_K3 = [("mamba2-1.3b SMOKE", 1, 11, 8, 16, 16, 8),
              ("mamba2-1.3b SMOKE", 4, 8, 8, 16, 16, 8)]


def example_kernel_phase(dev, reps=(10, 3)) -> dict:
    """K1, K2 and K3 against their plain versions at the twins' shapes,
    f32 (the twins' dtype), with the f32 tolerances of the kernel phases
    (K2 and K3 through their kernel phases' code)."""
    from repro_torch.kernels.decode_attention import ops as k1, ref as r1

    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    out = {"K1": [], "K2": [], "K3": []}
    arch, h, kv, d, lanes = EXAMPLE_K1
    q, kp, vp, bt, rows, pos, n_valid, bt_np, rows_np, pos_np = \
        kernel_inputs(dev, np.random.default_rng(16), h, kv, d,
                      EXAMPLE_K1_ROWS, lanes)
    assert bt.shape[1] == 4 and n_valid <= lanes
    for window in (8, None):          # gemma2's local and global layers
        kw = dict(window=window, softcap=50.0)
        case, o = checked_case(
            lambda: k1.ragged_paged_attention(q, kp, vp, bt, rows, pos, **kw),
            lambda: r1.ragged_paged_attention_ref(q, kp, vp, bt, rows, pos,
                                                  **kw),
            F32_TOL, *work(bt_np, rows_np, pos_np, window, 4, 4, False, h,
                           kv, d),
            torch.float32, flush, reps, arch=arch, T=lanes, H=h, K=kv, D=d,
            kv_dtype="float32", window=window, softcap=50.0,
            library_ms=None, route=k1.ragged_paged_attention_route(q, kp))
        assert bool((o[n_valid:] == 0).all()), "pad lanes not zero"
        out["K1"].append(case)
        emit({"phase": "examples_kernel", "kernel": "K1", **case})
    del flush
    out["K2"] = flash_kernel_phase(dev, [EXAMPLE_K2], reps)
    out["K3"] = ssd_kernel_phase(dev, EXAMPLE_K3, reps, (torch.float32,))
    return out


def run_example(name: str) -> dict:
    """Run one twin in this process as ``python examples_torch/<name>.py``
    would (at its defaults, on the card), its kernel counts set to 0 just
    before and read just after; it must print ``OK`` last."""
    import io
    import runpy

    from repro_torch import kernels

    path = EXAMPLES_DIR / f"{name}.py"
    argv, sys.argv = sys.argv, [str(path)]
    for fn in kernels._counted().values():
        fn.launches = 0
    out = io.StringIO()
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = argv
    seconds = time.monotonic() - t0
    launches = kernels.launch_counts()
    lines = out.getvalue().splitlines()
    assert lines and lines[-1] == "OK", (name, lines[-5:])
    for kernel in EXAMPLE_KERNELS.get(name, ()):
        assert launches[kernel] > 0, (name, kernel, launches)
    gc.collect()
    torch.cuda.empty_cache()
    return {"seconds": seconds, "launches": launches, "said": lines[-4:-1]}


def examples_phase(dev) -> dict:
    """The six twins of ``examples/*.py`` (``examples_torch/``), each run
    to ``OK`` on the card at its defaults after K1, K2 and K3 are held to
    their plain versions at the twins' shapes; every engine, node and
    model the twins made is gone when it returns."""
    t0 = time.monotonic()
    gc.collect()
    live = set(_live_cuda_tensors())
    checks = example_kernel_phase(dev)
    runs = {}
    for name in EXAMPLES:
        runs[name] = run_example(name)
        emit({"phase": "examples", "example": name, **runs[name]})
    gc.collect()
    torch.cuda.empty_cache()
    left = {p: v for p, v in _live_cuda_tensors().items() if p not in live}
    seconds = time.monotonic() - t0
    emit({"phase": "examples_total", "seconds": seconds,
          "budget_s": EXAMPLES_BUDGET_S,
          "allocated_outside_workspaces": allocated_outside_workspaces(),
          "tensors_left": len(left)})
    assert not left, sorted(left.values(), reverse=True)[:8]
    assert seconds <= EXAMPLES_BUDGET_S, seconds
    return {"checks": checks, "runs": runs}


# device bytes the libraries may keep for the process once their caches
# are dropped: torch's cuBLASLt workspace (1 MiB by default, no API frees
# it), generator states and the allocator's rounding of the kernels'
# workspaces; a phase's leftovers are held to zero on their own
LIBRARY_STATE_BYTES = 4 << 20


def _live_cuda_tensors() -> dict:
    """Storage bytes of the real CUDA tensors Python still reaches (not
    the kernels' workspaces, not a compiler's fake tensors), by data_ptr."""
    from repro_torch import kernels

    skip = {b.data_ptr() for b in kernels._workspaces.values()}
    live = {}
    for o in gc.get_objects():
        if type(o) in (torch.Tensor, torch.nn.Parameter) and o.is_cuda:
            ptr = o.untyped_storage().data_ptr()
            if ptr not in skip:
                live[ptr] = (o.untyped_storage().nbytes(), str(o.dtype),
                             tuple(o.shape))
    return live


def nothing_left_allocated() -> None:
    """Before the training phases: no earlier phase left device memory
    allocated.  The kernels' shared workspaces aside, Python reaches no
    CUDA tensor, and once the libraries' caches an earlier phase filled are
    dropped (cuBLAS's workspaces, one per handle and stream; the compiled
    flex_attention of the library timings) at most the libraries' own state
    (``LIBRARY_STATE_BYTES``) stays allocated."""
    import torch._dynamo

    gc.collect()
    torch.cuda.empty_cache()
    before = allocated_outside_workspaces()
    _compiled_flex.cache_clear()
    torch._dynamo.reset()
    torch._C._cuda_clearCublasWorkspaces()
    gc.collect()
    torch.cuda.empty_cache()
    left = allocated_outside_workspaces()
    live = _live_cuda_tensors()
    emit({"phase": "training_start",
          "allocated_outside_workspaces": before,
          "after_dropping_library_caches": left,
          "live_tensors": len(live),
          "live_tensor_bytes": sum(v[0] for v in live.values()),
          "largest_live": sorted(live.values(), reverse=True)[:8]})
    assert not live, sorted(live.values(), reverse=True)[:8]
    assert left <= LIBRARY_STATE_BYTES, left


# =================================================================== main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build

    # torch.compile's caches (the library timing's flex_attention) stay in
    # the checkout's git-ignored build directory
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build.BUILD_DIR / "inductor")
    os.environ["TRITON_CACHE_DIR"] = str(build.BUILD_DIR / "triton")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "env", "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": build.build()})
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        seconds[name] = time.monotonic() - t0
        return out

    cases = timed("kernel", kernel_phase, dev)
    flash = timed("flash_kernel", flash_kernel_phase, dev)
    ssd = timed("ssd_kernel", ssd_kernel_phase, dev)
    decode = timed("decode_kernel", decode_kernel_phase, dev)
    timed("score_check", score_check_phase, get_config("gemma2-9b"), dev)
    timed("ssm_check", ssm_check_phase, dev)
    timed("w1", w1_phase, dev)
    main_run = timed("serve", serve_phase, dev, smi)
    dense = timed("serve_dense", serve_dense_phase, dev, smi)
    timed("preempt", preempt_phases, dev, smi)
    timed("cluster", cluster_phase, dev, smi, main_run)
    mesh = timed("mesh", mesh_phase, dev, smi)
    moe = timed("serve_moe", serve_moe_phase, dev, smi)
    timed("moe_check", moe_check_phase, dev, smi)
    embeds = timed("embeds", embeds_phases, dev, smi)
    scores = timed("score", score_phase, dev, smi)
    nothing_left_allocated()
    grads = timed("grad_kernel", grad_kernel_phase, dev)
    timed("train_check", train_check_phase, dev)
    train = timed("train", train_phase, dev, smi)
    timed("train_ft", train_ft_phase, dev)
    sharded = timed("sharded", sharded_phase, dev, smi)
    dryrun = timed("dryrun", dryrun_phase, smi)
    examples = timed("examples", examples_phase, dev)
    # where the script's run time goes, for the next phase's budget (the
    # four training phases: 120 s)
    seconds["training"] = sum(seconds[k] for k in (
        "grad_kernel", "train_check", "train", "train_ft"))
    emit({"phase": "seconds", **seconds})
    emit({"phase": "dryrun_summary", "covered": dryrun["covered"],
          "uncovered": dryrun["uncovered"], "seconds": dryrun["seconds"]})
    rep = next(c for c in cases if c["kv_dtype"] == "bfloat16"
               and c["window"] is None and c["softcap"] == 50.0)
    # K2's representative case: a global layer of gemma2-9b's score forward
    rep2 = next(c for c in flash if c["arch"] == "gemma2-9b"
                and c["S"] == 8192 and c["dtype"] == "bfloat16"
                and c["window"] is None and c["softcap"] == 50.0)
    # K3's representative case: a mamba2-1.3b layer prefilling the serve
    # phase's 4500-token prompt from its (zero) cache state, as the main
    # path calls it; K4's: zamba2-2.7b's shared attention over 8 slots
    rep3 = next(c for c in ssd if c["arch"] == "mamba2-1.3b"
                and c["S"] == 4500 and c["dtype"] == "bfloat16" and c["h0"]
                and not c["D"])
    rep4 = next(c for c in decode if c["arch"] == "zamba2-2.7b"
                and c["kv_dtype"] == "bfloat16")
    # K1 and K2 at the MoE configs' head_dim 128
    d128 = lambda cases: [{k: c.get(k) for k in (
        "arch", "H", "K", "S", "kernel_ms", "bound_ms", "bound_by",
        "plain_ms", "library_ms", "max_abs_err")} for c in cases
        if c.get("D") == 128]
    # K2 and K4 at the embeds configs' head_dims (64, 96), and their
    # launches on the embeds paths
    embeds_cases = lambda cases: [{k: c.get(k) for k in (
        "arch", "B", "S", "H", "K", "D", "kernel_ms", "bound_ms", "bound_by",
        "plain_ms", "library_ms", "max_abs_err")} for c in cases
        if c["arch"] in EMBEDS_ARCHS]
    embeds_launches = {arch: {
        "score_embeds_k2": run["score"]["k2_launches"],
        "embeds_check": run["check"]["launches"],
        "serve_embeds_k2": run["serve"]["launches"]["K2"]}
        for arch, run in embeds.items()}
    # each kernel's launches in each twin's run, and its cases at the
    # twins' shapes
    twin_launches = lambda name: {ex: run["launches"][name]
                                  for ex, run in examples["runs"].items()}
    print(smi)
    emit({"kernels": [{
        "name": "ragged_paged_attention", "id": "K1", "route": "cuda",
        "source": K1_SRC, "replaces": K1_TPU,
        "tpu": "kernels/decode_attention/kernel.py:ragged_paged_attention_fwd",
        "port": K1_SRC, "checked": True,
        "launches": main_run["k1_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": rep["kernel_ms"], "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
        "library_ms": None,
        "shape": "T=512 H=16 K=8 D=256 bs=16, bf16 q and pool, softcap 50",
        "launches_serve_moe": moe["k1_launches"], "d128": d128(cases),
        "launches_mesh": mesh["k1_launches"],
        "mesh_ticks": mesh["ticks"],
        "mesh_cases": [{k: c.get(k) for k in (
            "shard", "kv_dtype", "H", "K", "pool_K", "kv_heads",
            "kernel_ms", "bound_ms", "bound_by", "plain_ms", "max_abs_err")}
            for c in mesh["kernel_cases"]],
        "launches_examples": twin_launches("ragged_paged_attention"),
        "examples_cases": examples["checks"]["K1"]}, {
        "name": "flash_attention", "id": "K2", "route": "cuda",
        "source": K2_SRC, "replaces": K2_TPU,
        "tpu": "kernels/flash_attention/kernel.py:flash_attention_fwd",
        "port": K2_SRC, "checked": True,
        "launches": scores[0]["k2_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in flash),
        "ms": rep2["kernel_ms"], "plain_ms": rep2["plain_ms"],
        "bound_ms": rep2["bound_ms"], "bound_by": rep2["bound_by"],
        "library_ms": rep2["library_ms"],
        "library_note": "flex_attention (torch.compile'd): tanh softcap as "
                        "score_mod, causal block mask, enable_gqa; the port "
                        "never calls it",
        "shape": "B=1 S=8192 H=16 K=8 D=256, bf16, causal, no window, "
                 "softcap 50 (gemma2-9b's global layers)",
        "d128": d128(flash), "d64_d96": embeds_cases(flash),
        "launches_embeds": embeds_launches,
        "launches_train_step": train["launches_per_step"]["K2"],
        "launches_sharded": sharded["launches"]["K2"],
        "launches_sharded_moe": sharded["launches_moe"]["K2"],
        "autograd": grads["K2"],
        "launches_examples": twin_launches("flash_attention"),
        "examples_cases": examples["checks"]["K2"]}, {
        "name": "ssd", "id": "K3", "route": "cuda",
        "source": K3_SRC, "replaces": K3_TPU,
        "tpu": "kernels/ssd/kernel.py:ssd_fwd",
        "port": K3_SRC, "checked": True,
        "launches": dense["mamba2-1.3b"]["launches"]["K3"],
        "max_abs_err": max(c["max_abs_err"] for c in ssd),
        "ms": rep3["kernel_ms"], "plain_ms": rep3["plain_ms"],
        "bound_ms": rep3["bound_ms"], "bound_by": rep3["bound_by"],
        "library_ms": None,
        "shape": "B=1 S=4500 H=64 P=64 N=128 chunk 256, bf16 x/B/C, f32 y "
                 "and h_final, h0 given, no D (a mamba2-1.3b layer's "
                 "prefill)",
        "launches_train_step": train["launches_per_step"]["K3"],
        "launches_sharded": sharded["launches"]["K3"],
        "autograd": grads["K3"],
        "launches_examples": twin_launches("ssd"),
        "examples_cases": examples["checks"]["K3"]}, {
        "name": "decode_attention", "id": "K4", "route": "cuda",
        "source": K4_SRC, "replaces": K4_TPU,
        "tpu": "kernels/decode_attention/kernel.py:decode_attention_fwd",
        "port": K4_SRC, "checked": True,
        "launches": dense["zamba2-2.7b"]["launches"]["K4"],
        "max_abs_err": max(c["max_abs_err"] for c in decode),
        "ms": rep4["kernel_ms"], "plain_ms": rep4["plain_ms"],
        "bound_ms": rep4["bound_ms"], "bound_by": rep4["bound_by"],
        "library_ms": rep4["library_ms"],
        "library_note": "scaled_dot_product_attention with an additive "
                        "mask of the invisible slots; the port never calls "
                        "it",
        "shape": "B=8 S=8192 H=K=32 D=160, bf16, rows filled to 49..8192 "
                 "slots (zamba2-2.7b's shared attention)",
        "d64_d96": embeds_cases(decode),
        "launches_embeds": {arch: launches["embeds_check"]["K4"]
                            for arch, launches in embeds_launches.items()},
        "launches_sharded": sharded["launches"]["K4"],
        "launches_sharded_moe": sharded["launches_moe"]["K4"],
        "launches_examples": twin_launches("decode_attention")
        }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
