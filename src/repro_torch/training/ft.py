"""Fault tolerance for long-running training jobs.

Port of the JAX package's ``training/ft.py``:

1. **Checkpoint/restart** — ``FaultTolerantLoop`` snapshots the train state
   into the Cascade persistent log every ``ckpt_every`` steps (async
   write-back; the log's stable-prefix rule means a restart never reads a
   torn checkpoint) and once more, stably, at the end.  On construction it
   restores the newest checkpoint, so a killed job resumes where the log is
   stable and loses at most ``ckpt_every`` steps.

2. **Straggler mitigation** — ``StepMonitor`` keeps a rolling step-time
   distribution; a step slower than ``threshold ×`` the rolling median is a
   straggler, recorded and passed to an optional callback.

3. **Elastic scaling** — ``elastic_reshard`` moves a state tree onto another
   device mesh (``launch.sharding``), bit for bit.

The loop waits for each step's loss on the device (one sync a step, the
counterpart of the reference's ``jax.block_until_ready``) so that its step
times are device times.
"""
from __future__ import annotations

import statistics
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from .checkpoint import CheckpointManager


@dataclass
class StepMonitor:
    window: int = 32
    threshold: float = 2.0
    times: deque = field(default_factory=lambda: deque(maxlen=128))
    stragglers: list[int] = field(default_factory=list)

    def observe(self, step: int, dt_s: float) -> bool:
        self.times.append(dt_s)
        if len(self.times) < 8:
            return False
        med = statistics.median(self.times)
        if dt_s > self.threshold * med:
            self.stragglers.append(step)
            return True
        return False

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0


def _block_until_ready(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


class FaultTolerantLoop:
    """Wraps a train step with checkpoint/restart + straggler watch."""

    def __init__(self, train_step, state, *, ckpt: CheckpointManager,
                 ckpt_every: int = 50, monitor: StepMonitor | None = None,
                 on_straggler: Callable[[int], None] | None = None) -> None:
        self.train_step = train_step
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.monitor = monitor or StepMonitor()
        self.on_straggler = on_straggler
        self.step = 0
        self.state = state
        # restart path: resume from the newest stable checkpoint if present
        if ckpt.latest_step() is not None:
            self.step, self.state = ckpt.restore(state)

    def run(self, batches, n_steps: int, *, metrics_cb=None) -> Any:
        it = iter(batches)
        target = self.step + n_steps
        while self.step < target:
            batch = next(it)
            t0 = time.monotonic()
            self.state, metrics = self.train_step(self.state, batch)
            _block_until_ready(metrics["loss"])
            dt = time.monotonic() - t0
            self.step += 1
            if self.monitor.observe(self.step, dt) and self.on_straggler:
                self.on_straggler(self.step)
            if metrics_cb:
                metrics_cb(self.step, metrics, dt)
            if self.step % self.ckpt_every == 0:
                self.ckpt.save(self.step, self.state, wait=False)
        # final stable checkpoint
        self.ckpt.save(self.step, self.state, wait=True)
        return self.state


def elastic_reshard(tree, new_mesh, spec_fn) -> Any:
    """Move a tree of tensors or ``ShardedTensor``s onto ``new_mesh``:
    ``spec_fn(path, leaf) -> spec`` (a tuple of mesh-axis names, as
    ``launch.sharding.leaf_spec`` gives), ``path`` the leaf's ``/``-joined
    name (``tree.named_leaves``).  Every leaf comes back a ShardedTensor
    with the same bits."""
    from repro_torch.launch.sharding import Placement, reshard
    from repro_torch.tree import named_leaves, tree_map

    it = iter(named_leaves(tree))

    def move(leaf):
        path, _ = next(it)
        return reshard(leaf, Placement(new_mesh, tuple(spec_fn(path, leaf))))

    return tree_map(move, tree)
