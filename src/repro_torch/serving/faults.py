"""Deterministic fault injection for the serving fast path (copied from
the JAX package's ``serving/faults.py``).

Vortex-style hosting (PAPERS.md) stands or falls on what happens when a
component stalls or dies; this module makes those conditions a first-class,
REPRODUCIBLE input instead of a hardware accident.  A ``FaultInjector``
holds a seeded schedule of ``FaultSpec``s and installs at three seams:

- **engine tick** (``ServeEngine.tick`` entry, tick thread): CRASH marks
  the engine crashed and raises ``ReplicaCrashed``; STALL makes the busy
  engine no-op forever (tick returns 0 without dispatching — the model of a
  wedged replica, detected only by the deployment's progress watchdog);
  SLOW_TICK sleeps ``duration_s`` before the dispatch for ``count`` ticks
  (progress continues, so the watchdog tolerates it — this is the fault
  that exercises per-request deadlines, not failover).
- **engine submit** (upcall thread): SUBMIT_ERROR raises the transient
  ``InjectedFault`` for ``count`` consecutive submits — the deployment's
  bounded retry moves the request to a sibling.
- **store trigger_put** (client thread, via ``CascadeStore.fault_hook``):
  SUBMIT_ERROR specs with ``seam="store"`` fail the trigger_put itself —
  the deployment-level backoff/retry seam.

Faults fire at tick/submit ENTRY only, never mid-dispatch: the engine
updates its pool in place during a dispatch (and replays a captured graph
that writes it), so a fault landing inside a tick could strand the pool in
a half-written state; firing at the seam keeps every recovery path
exercised without modeling torn device state.

Interplay with preemption (``ServeEngine(preempt=True)``): the tick seam
fires BEFORE ``_maybe_preempt``, so a crash can never land between a
victim's spill and its requeue — a preemption either completed on an
earlier tick (the victim is back in the queue, its KV parked in the
deployment-shared ``SpillPool``) or never started.  A crashed replica's
evacuation then drains preempted requests as ordinary QUEUED entries;
``_re_home`` submits them to a sibling, whose admission unparks the shared
pool entry and ``adopt``s it — or falls back to prompt replay if the pool
evicted it.  Either way the stream stays bit-identical under greedy
decoding, which is what the chaos suite asserts with preemption enabled.

Everything here is pure host logic — no device work, one internal lock —
so the lock-order tracker holds trivially and the engine's one sync site
stays its only device→host pull.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from enum import Enum


class FaultKind(str, Enum):
    CRASH = "crash"              # replica dies at tick entry
    STALL = "stall"              # replica wedges: busy but never progresses
    SLOW_TICK = "slow_tick"      # tick sleeps duration_s (progress continues)
    SUBMIT_ERROR = "submit_error"  # transient failure at a submit seam


class ReplicaCrashed(RuntimeError):
    """The replica is dead: permanent until the deployment marks it down."""


class InjectedFault(RuntimeError):
    """A transient injected failure (submit/store seam): retry elsewhere."""


@dataclass
class FaultSpec:
    """One scheduled fault.

    ``deployment``/``replica`` select the target ("*" / -1 = first match).
    ``at_tick`` arms tick faults once the target's observed tick count
    reaches it; a NEGATIVE at_tick is resolved at injector construction to a
    seeded draw from [1, -at_tick] (deterministic chaos schedules).
    ``at_submit``/``count`` arm submit faults for ``count`` consecutive
    submit events starting at the ``at_submit``-th.  ``kv_recoverable``
    models whether a crashed replica's KV pool can still be spilled
    (False = the sessions fall back to prompt replay)."""
    kind: FaultKind
    deployment: str = "*"
    replica: int = -1
    at_tick: int = 1
    at_submit: int = 0
    count: int = 1
    duration_s: float = 0.0
    kv_recoverable: bool = True
    seam: str = "engine"          # SUBMIT_ERROR only: "engine" | "store"
    # resolved/armed state (injector-internal):
    fired: int = field(default=0, compare=False)
    bound: tuple | None = field(default=None, compare=False)


class _BoundSeam:
    """One (deployment, replica)'s view of the injector — what an engine's
    ``faults`` attribute holds."""

    def __init__(self, injector: "FaultInjector", deployment: str,
                 replica: int) -> None:
        self._inj = injector
        self.deployment = deployment
        self.replica = replica

    def on_tick(self, engine) -> str | None:
        return self._inj.on_tick(engine, self.deployment, self.replica)

    def on_submit(self) -> None:
        self._inj.on_submit(self.deployment, self.replica)


class FaultInjector:
    """Seeded deterministic fault schedule over the serving seams."""

    def __init__(self, specs: list[FaultSpec], seed: int = 0) -> None:
        rng = random.Random(seed)
        self.specs = list(specs)
        for spec in self.specs:
            if spec.at_tick < 0:
                spec.at_tick = rng.randrange(1, -spec.at_tick + 1)
        self._lock = threading.Lock()
        self._ticks: dict[tuple[str, int], int] = {}
        self._submits: dict[tuple[str, int], int] = {}
        self.fired_log: list[str] = []

    # ------------------------------------------------------------ installers
    def bind(self, deployment: str, replica: int) -> _BoundSeam:
        """The engine-seam hook: assign to ``engine.faults`` (deployments do
        this via ``ModelDeployment.install_faults``)."""
        return _BoundSeam(self, deployment, replica)

    def store_hook(self):
        """The store-seam hook: assign to ``CascadeStore.fault_hook``; fires
        SUBMIT_ERROR specs with ``seam="store"`` whose deployment name
        appears in the trigger_put key."""
        def hook(key: str) -> None:
            with self._lock:
                for spec in self.specs:
                    if (spec.kind is not FaultKind.SUBMIT_ERROR
                            or spec.seam != "store"
                            or spec.fired >= spec.count):
                        continue
                    if (spec.deployment != "*"
                            and f"/{spec.deployment}/" not in key):
                        continue
                    spec.fired += 1
                    self.fired_log.append(f"store_submit_error:{key}")
                    raise InjectedFault(
                        f"injected store submit error on {key}")
        return hook

    # ----------------------------------------------------------- seam events
    def _matches(self, spec: FaultSpec, deployment: str, replica: int) -> bool:
        if spec.deployment != "*" and spec.deployment != deployment:
            return False
        if spec.replica >= 0 and spec.replica != replica:
            return False
        # single-target faults latch onto whoever fired them first, so a
        # wildcard CRASH kills exactly one replica
        if spec.bound is not None and spec.bound != (deployment, replica):
            return False
        return True

    def on_tick(self, engine, deployment: str, replica: int) -> str | None:
        """Called at tick ENTRY by the bound engine.  Returns "stall" for a
        wedged tick, sleeps for slow ticks, raises ``ReplicaCrashed`` for a
        crash (after flagging the engine so later submits bounce)."""
        sleep_s = 0.0
        verdict: str | None = None
        crash: FaultSpec | None = None
        with self._lock:
            k = (deployment, replica)
            self._ticks[k] = self._ticks.get(k, 0) + 1
            t = self._ticks[k]
            for spec in self.specs:
                if not self._matches(spec, deployment, replica):
                    continue
                if spec.kind is FaultKind.CRASH:
                    if spec.fired == 0 and t >= spec.at_tick:
                        spec.fired = 1
                        spec.bound = k
                        self.fired_log.append(
                            f"crash:{deployment}/r{replica}@tick{t}")
                        crash = spec
                elif spec.kind is FaultKind.STALL:
                    if t >= spec.at_tick:
                        if spec.fired == 0:
                            spec.fired = 1
                            spec.bound = k
                            self.fired_log.append(
                                f"stall:{deployment}/r{replica}@tick{t}")
                        verdict = "stall"
                elif spec.kind is FaultKind.SLOW_TICK:
                    if t >= spec.at_tick and spec.fired < spec.count:
                        spec.fired += 1
                        spec.bound = k
                        sleep_s = max(sleep_s, spec.duration_s)
        if crash is not None:
            engine.crashed = True
            engine.kv_recoverable = crash.kv_recoverable
            raise ReplicaCrashed(
                f"injected crash: {deployment}/replica{replica}")
        if sleep_s > 0.0:
            time.sleep(sleep_s)
        return verdict

    def on_submit(self, deployment: str, replica: int) -> None:
        """Called at submit ENTRY by the bound engine (upcall thread)."""
        with self._lock:
            k = (deployment, replica)
            self._submits[k] = self._submits.get(k, 0) + 1
            s = self._submits[k]
            for spec in self.specs:
                if (spec.kind is not FaultKind.SUBMIT_ERROR
                        or spec.seam != "engine"
                        or not self._matches(spec, deployment, replica)):
                    continue
                if s > spec.at_submit and spec.fired < spec.count:
                    spec.fired += 1
                    spec.bound = spec.bound or k
                    self.fired_log.append(
                        f"submit_error:{deployment}/r{replica}@submit{s}")
                    raise InjectedFault(
                        f"injected submit error: {deployment}/"
                        f"replica{replica}")


def poisoned_lambda(exc: type[BaseException] = RuntimeError,
                    msg: str = "injected lambda poison"):
    """An always-raising upcall fn — the dispatcher-seam fault (a poisoned
    request's lambda raising on the upcall thread); the dispatcher must
    contain and count it (``Dispatcher.stats().upcall_errors``), never let
    it wedge the thread."""
    def fn(_obj, _event):
        raise exc(msg)
    return fn
