"""Runtime sanitizers of the port: lock-order tracking and host-sync call
sites.

The port's counterpart of the JAX package's ``analysis/sanitizer.py``.  The
static passes see one file at a time; these two see the process.

**LockOrderTracker** (the JAX package's tracker, keyed on ``repro_torch.``)
wraps ``threading.Lock``/``RLock`` *creation* (only for locks created by
``repro_torch.*`` modules — the caller frame is inspected so torch/stdlib
internals keep their native locks).  Every tracked acquire records an
edge ``held -> wanted`` in a global acquisition graph; an acquire that
closes a cycle in that graph is a lock-order inversion — two threads
interleaving those paths can deadlock — and is recorded as a violation
immediately, with both edge sites.  Blocking re-acquire of a
non-reentrant Lock already held by the same thread (guaranteed
self-deadlock) is also a violation.  Violations are collected, not
raised: the threaded tests assert ``tracker.violations == []`` at
teardown, so a latent inversion fails tier-1 even when the schedule that
would deadlock never ran.

**SyncSiteSanitizer** patches torch's host transfers — ``Tensor.cpu``,
``Tensor.item``, ``Tensor.tolist``, ``Tensor.to`` with a CPU target and
``torch.cuda.synchronize`` — and checks the caller stack: if the nearest
``repro_torch.*`` frame is in the fast path (``repro_torch.serving``,
``repro_torch.models``, ``repro_torch.kernels``) and is neither the sync
site (``repro_torch.serving.engine::_to_host``) nor an allowlisted offline
helper (``OFFLINE_HELPERS``), the call is a violation, *whatever the
tensor's device*: the CPU tests guard what the card would pay.  The one
exception is ``Tensor.to``, which is a host transfer only from a device
tensor: on the CPU a ``.to(device)`` of the engine's own device moves
nothing (the static pass flags a literal ``.to("cpu")``).  Calls from
tests or offline tooling (no fast-path frame) pass through untouched — the
runtime twin of the static host-sync pass.
"""
from __future__ import annotations

import sys
import threading
from dataclasses import dataclass

import torch

_FASTPATH_PREFIXES = ("repro_torch.serving", "repro_torch.models",
                      "repro_torch.kernels", "repro_torch.launch")
ALLOWED_SYNC_SITES = {("repro_torch.serving.engine", "_to_host")}
# fast-path functions that only tests, checkpoints and chip_smoke's checks
# call, each with the reason it may pull to the host
OFFLINE_HELPERS = {
    ("repro_torch.models.lm", "_to_numpy"):
        "numpy conversion of params, pools and caches for the parity tests",
    ("repro_torch.kernels.decode_attention.ref",
     "ragged_paged_attention_ref"):
        "K1's plain version: the wrapper's CPU route and the card's checks",
}


def _caller_module(depth: int) -> str:
    try:
        frame = sys._getframe(depth)
    except ValueError:
        return ""
    return frame.f_globals.get("__name__", "") or ""


@dataclass
class _Edge:
    src: str
    dst: str
    where: str           # "thread-name @ module" of the acquire that added it


class TrackedLock:
    """Lock/RLock proxy reporting acquire/release to a LockOrderTracker."""

    def __init__(self, tracker: "LockOrderTracker", inner,
                 name: str, reentrant: bool) -> None:
        self._tracker = tracker
        self._inner = inner
        self._name = name
        self._reentrant = reentrant

    # threading.Condition probes these via getattr on RLocks
    def __getattr__(self, item):
        return getattr(self._inner, item)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking and self._tracker._before_acquire(self):
            # guaranteed self-deadlock: already recorded, fail fast
            # instead of hanging the suite
            raise RuntimeError(
                f"self-deadlock: re-acquire of held {self._name}")
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._tracker._acquired(self)
        return got

    def release(self) -> None:
        self._inner.release()
        self._tracker._released(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TrackedLock {self._name}>"


class LockOrderTracker:
    """Global acquisition graph over all tracked locks, cycle = violation."""

    def __init__(self) -> None:
        self.violations: list[str] = []
        self._edges: dict[str, dict[str, _Edge]] = {}
        self._held = threading.local()
        self._graph_lock = threading.Lock()   # native: guards the graph
        self._installed = False
        self._orig_lock = None
        self._orig_rlock = None
        self._counter = 0

    # ------------------------------------------------------------ wrapping
    def wrap(self, inner=None, name: str | None = None,
             reentrant: bool = False) -> TrackedLock:
        with self._graph_lock:
            self._counter += 1
            n = self._counter
        if inner is None:
            inner = (self._orig_rlock or threading.RLock)() if reentrant \
                else (self._orig_lock or threading.Lock)()
        label = name or f"lock-{n}"
        return TrackedLock(self, inner, f"{label}#{n}", reentrant)

    def install(self, module_prefixes: tuple[str, ...] = ("repro_torch.",)
                ) -> None:
        """Patch threading.Lock/RLock for locks created by our modules."""
        if self._installed:
            return
        self._orig_lock = threading.Lock
        self._orig_rlock = threading.RLock
        tracker = self

        def make_lock():
            mod = _caller_module(2)
            if mod.startswith(module_prefixes):
                return tracker.wrap(tracker._orig_lock(), name=mod,
                                    reentrant=False)
            return tracker._orig_lock()

        def make_rlock():
            mod = _caller_module(2)
            if mod.startswith(module_prefixes):
                return tracker.wrap(tracker._orig_rlock(), name=mod,
                                    reentrant=True)
            return tracker._orig_rlock()

        threading.Lock = make_lock          # type: ignore[assignment]
        threading.RLock = make_rlock        # type: ignore[assignment]
        self._installed = True

    def uninstall(self) -> None:
        if not self._installed:
            return
        threading.Lock = self._orig_lock    # type: ignore[assignment]
        threading.RLock = self._orig_rlock  # type: ignore[assignment]
        self._installed = False

    # ----------------------------------------------------------- recording
    def _stack(self) -> list[TrackedLock]:
        if not hasattr(self._held, "stack"):
            self._held.stack = []
        return self._held.stack

    def _before_acquire(self, lock: TrackedLock) -> bool:
        """Record edges; True iff this acquire would self-deadlock."""
        held = self._stack()
        if not held:
            return False
        if any(h is lock for h in held):
            if not lock._reentrant:
                with self._graph_lock:
                    self.violations.append(
                        f"self-deadlock: "
                        f"{threading.current_thread().name} blocking "
                        f"re-acquire of non-reentrant {lock._name} "
                        f"it already holds")
                return True
            return False
        where = (f"{threading.current_thread().name} @ "
                 f"{_caller_module(3)}")
        with self._graph_lock:
            for h in held:
                edges = self._edges.setdefault(h._name, {})
                if lock._name not in edges:
                    edges[lock._name] = _Edge(h._name, lock._name, where)
                cycle = self._find_path(lock._name, h._name)
                if cycle is not None:
                    self.violations.append(
                        f"lock-order inversion: acquiring {lock._name} "
                        f"while holding {h._name} ({where}), but the "
                        f"reverse order {' -> '.join(cycle)} was taken at "
                        f"{self._edges[cycle[0]][cycle[1]].where}")
        return False

    def _acquired(self, lock: TrackedLock) -> None:
        self._stack().append(lock)

    def _released(self, lock: TrackedLock) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is lock:
                del stack[i]
                return

    def _find_path(self, src: str, dst: str) -> list[str] | None:
        """DFS path src -> dst in the acquisition graph (caller holds
        the graph lock)."""
        seen: set[str] = set()
        path: list[str] = []

        def dfs(node: str) -> bool:
            if node == dst:
                path.append(node)
                return True
            if node in seen:
                return False
            seen.add(node)
            for nxt in self._edges.get(node, ()):
                if dfs(nxt):
                    path.append(node)
                    return True
            return False

        if dfs(src):
            return list(reversed(path))
        return None


class SyncSiteSanitizer:
    """Patch torch's host transfers: fast-path frames must be the sync
    site (or an allowlisted offline helper)."""

    def __init__(self, allowed=ALLOWED_SYNC_SITES,
                 offline=tuple(OFFLINE_HELPERS)) -> None:
        self.allowed = set(allowed) | set(offline)
        self.violations: list[str] = []
        self._installed = False
        self._orig: dict[tuple[object, str], tuple[object, bool]] = {}

    def _check(self, what: str) -> None:
        site = self._fastpath_caller()
        if site is not None and site not in self.allowed:
            self.violations.append(
                f"{what} called from {site[0]}::{site[1]} — the fast path "
                f"syncs only in {sorted(ALLOWED_SYNC_SITES)}")

    def install(self) -> None:
        if self._installed:
            return
        sanitizer = self

        def patch(owner, name, wrap):
            orig = getattr(owner, name)
            self._orig[(owner, name)] = (orig, name in vars(owner))
            setattr(owner, name, wrap(orig))

        def pulls(what):
            def wrap(orig):
                def call(*args, **kwargs):
                    sanitizer._check(what)
                    return orig(*args, **kwargs)
                return call
            return wrap

        def to_wrap(orig):
            def to(t, *args, **kwargs):
                # the target device, as Tensor.to reads its arguments
                # (``copy``, last, aside: the parser does not take it)
                kw = {k: v for k, v in kwargs.items() if k != "copy"}
                try:
                    target = torch._C._nn._parse_to(*args, **kw)[0]
                except RuntimeError:
                    target = torch._C._nn._parse_to(*args[:-1], **kw)[0]
                if target is not None and target.type == "cpu" \
                        and t.device.type != "cpu":
                    sanitizer._check("Tensor.to(<cpu>)")
                return orig(t, *args, **kwargs)
            return to

        for name in ("cpu", "item", "tolist"):
            patch(torch.Tensor, name, pulls(f"Tensor.{name}"))
        patch(torch.Tensor, "to", to_wrap)
        patch(torch.cuda, "synchronize", pulls("torch.cuda.synchronize"))
        self._installed = True

    def uninstall(self) -> None:
        if not self._installed:
            return
        for (owner, name), (orig, own) in self._orig.items():
            if own:
                setattr(owner, name, orig)
            else:                     # inherited: drop the patch again
                delattr(owner, name)
        self._orig.clear()
        self._installed = False

    @staticmethod
    def _fastpath_caller() -> tuple[str, str] | None:
        """Nearest ``repro_torch.*`` frame, if it is a fast-path module."""
        depth = 1
        while True:
            try:
                frame = sys._getframe(depth)
            except ValueError:
                return None
            mod = frame.f_globals.get("__name__", "") or ""
            if mod.startswith("repro_torch.") and mod != __name__:
                if mod.startswith(_FASTPATH_PREFIXES):
                    return (mod, frame.f_code.co_name)
                return None
            depth += 1
