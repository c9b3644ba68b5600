"""cascade-lint for the port: static analysis + runtime sanitizers.

The port's counterpart of the JAX package's ``analysis/``.  Cascade's
latency story rests on invariants the code can only state by convention;
this package makes three of them machine-checked over ``src/repro_torch``:

1. **Lock discipline** (``lock_discipline``, a copy of the JAX pass):
   every attribute a class mutates under one of its locks is mutated under
   that lock *everywhere*.
2. **Host-sync discipline** (``sync_discipline``): the serving fast path
   (``serving/``, ``models/``, ``kernels/``, ``launch/``,
   ``core/store.py``) has exactly ONE device→host sync site per tick,
   ``ServeEngine._to_host`` —
   ``host_syncs == ticks`` holds statically, not just when a test happens
   to trip it.
3. **Donation & recompile hazards** (``donation``): a tensor donated to a
   fused call (``fuse_stages``, ``FastPathPipeline.build(donate_input=
   True)``) holds a later call's input afterwards, so reading it is a
   use-after-donate; and a fused call fed a Python scalar or ``len(...)``
   captures a new graph for each value.

``runner`` is the CLI (``python -m repro_torch.analysis src/repro_torch``);
``sanitizer`` is the runtime half — a lock-order tracker (acquisition
graph + cycle detection) and a sync-site sanitizer over torch's host
transfers, wired into the port's threaded test suites.

Suppressions are inline pragmas with a one-line justification, with the
JAX package's grammar::

    # lint: guarded-by(seq_lock) per-shard sequencer serializes writers
    # lint: allow-sync(offline conversion; not on the serving fast path)
    # lint: allow-donated-read(operand is rebound before this read)
    # lint: static-ok(value is constant per build)
    # lint: sync-site(THE one per-tick device->host pull)
"""
from .base import Finding, Pragma, SourceInfo, iter_python_files
from .donation import DonationPass
from .lock_discipline import LockDisciplinePass
from .runner import ALL_PASSES, lint_paths, main
from .sync_discipline import SyncDisciplinePass

__all__ = [
    "Finding", "Pragma", "SourceInfo", "iter_python_files",
    "LockDisciplinePass", "SyncDisciplinePass", "DonationPass",
    "ALL_PASSES", "lint_paths", "main",
]
