"""Port parity: the seeded ``FaultInjector`` of ``repro_torch.serving.faults``
against the JAX package's, and engine-level failover on the port's engine
(a crash latched at tick entry, ``evacuate`` on the dead replica, ``adopt``
or replay on a sibling), on the CPU.

The same fault schedules driven through the same seam events give the same
verdicts, exceptions and ``fired_log`` in both packages; the migrated and
the replayed streams equal the JAX engine's uninterrupted run at fp32.
"""
import jax
import numpy as np
import pytest
import torch

import repro.models as J
from repro.serving import faults as jfaults
from repro.serving import scheduler as jsched
from repro.serving.engine import ServeEngine as JEngine
from repro_torch.analysis.sanitizer import LockOrderTracker, SyncSiteSanitizer
import repro_torch.models as P
from repro_torch.serving import faults as pfaults
from repro_torch.serving import scheduler as psched
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.faults import (FaultInjector, FaultKind, FaultSpec,
                                        InjectedFault, ReplicaCrashed)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def port_sanitizers():
    """The port's lock-order tracker and sync-site sanitizer around every
    test: a lock-order inversion, or a host transfer from the fast path
    outside ``ServeEngine._to_host``, fails it."""
    tracker, sync = LockOrderTracker(), SyncSiteSanitizer()
    tracker.install()
    sync.install()
    try:
        yield
    finally:
        tracker.uninstall()
        sync.uninstall()
    assert not tracker.violations, "; ".join(tracker.violations)
    assert not sync.violations, "; ".join(sync.violations)


_CFG = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=128, dtype="float32",
            q_chunk=16)                          # tests/test_faults.py:26
JCFG, PCFG = J.ModelConfig(**_CFG), P.ModelConfig(**_CFG)


class _Engine:
    crashed = False
    kv_recoverable = True


def _event(fn):
    try:
        return fn()
    except (jfaults.InjectedFault, jfaults.ReplicaCrashed,
            pfaults.InjectedFault, pfaults.ReplicaCrashed) as e:
        return type(e).__name__


def _drive(mod, scenario: str, seed: int):
    """One scripted run of seam events against ``mod``'s injector: every
    verdict or exception, the engines' flags and the fired log."""
    K = mod.FaultKind
    specs = {
        "seeded": [mod.FaultSpec(K.CRASH, at_tick=-10),
                   mod.FaultSpec(K.STALL, at_tick=-10, replica=1),
                   mod.FaultSpec(K.SLOW_TICK, at_tick=-4, count=2)],
        "crash_latch": [mod.FaultSpec(K.CRASH, at_tick=2,
                                      kv_recoverable=False)],
        "submit_errors": [mod.FaultSpec(K.SUBMIT_ERROR, count=2,
                                        at_submit=1)],
        "stall": [mod.FaultSpec(K.STALL, at_tick=3)],
        "store": [mod.FaultSpec(K.SUBMIT_ERROR, deployment="m",
                                seam="store", count=1)],
    }[scenario]
    inj = mod.FaultInjector(specs, seed=seed)
    engines = [_Engine(), _Engine()]
    seams = [inj.bind("m", 0), inj.bind("m", 1)]
    hook = inj.store_hook()
    trace = [[s.at_tick for s in inj.specs]]
    for i in range(12):
        r = i % 2
        trace.append(_event(lambda: seams[r].on_tick(engines[r])))
        if i % 3 == 0:
            trace.append(_event(lambda: seams[r].on_submit()))
    for key in ("/serve/m/req/a", "/serve/m/req/b", "/serve/x/req/a"):
        trace.append(_event(lambda: hook(key)))
    trace.append([(e.crashed, e.kv_recoverable) for e in engines])
    trace.append(list(inj.fired_log))
    return trace


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("scenario", ["seeded", "crash_latch",
                                      "submit_errors", "stall", "store"])
def test_injector_matches_the_reference(scenario, seed):
    assert _drive(pfaults, scenario, seed) == _drive(jfaults, scenario, seed)


def test_poisoned_lambda_raises_what_it_is_given():
    fn = pfaults.poisoned_lambda(ValueError, "bad")
    with pytest.raises(ValueError, match="bad"):
        fn(None, None)


# ======================================================== engine seams
@pytest.fixture(scope="module")
def params():
    jp = J.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, P.params_from_numpy(jax.tree.map(np.asarray, jp), PCFG,
                                   device="cpu")


def _prompts(n=4, seed=7):
    rng = np.random.default_rng(seed)
    return {f"r{i}": rng.integers(0, 128, (int(rng.integers(4, 12)),))
            .astype(np.int32) for i in range(n)}


def _reqs(mod, max_new=6):
    return [mod.Request(request_id=rid, session_key=f"s{i}", prompt=p,
                        max_new_tokens=max_new)
            for i, (rid, p) in enumerate(_prompts().items())]


def _engine(pp, **kw):
    return ServeEngine(PCFG, pp, n_slots=4, max_len=64, block_size=4,
                       num_blocks=64, prefix_cache=False, device="cpu", **kw)


def test_engine_seams_fire_at_tick_and_submit_entry(params):
    _, pp = params
    eng = _engine(pp)
    eng.faults = FaultInjector([
        FaultSpec(FaultKind.SUBMIT_ERROR, count=1),
        FaultSpec(FaultKind.STALL, at_tick=2)]).bind("m", 0)
    req = _reqs(psched)[0]
    with pytest.raises(InjectedFault):
        eng.submit(req)                   # nothing enqueued
    assert eng.idle()
    eng.submit(req)
    assert eng.tick() == 1 and eng.stats.ticks == 1   # the first token
    for _ in range(3):                    # wedged: busy, no progress
        assert eng.tick() == 0
    assert eng.stats.ticks == 1 and not eng.crashed
    crash = _engine(pp)
    crash.faults = FaultInjector([FaultSpec(FaultKind.CRASH, at_tick=1,
                                            kv_recoverable=False)]).bind("m", 0)
    crash.submit(_reqs(psched)[1])
    with pytest.raises(ReplicaCrashed):
        crash.tick()
    assert crash.crashed and not crash.kv_recoverable
    assert crash.stats.ticks == 0
    with pytest.raises(ReplicaCrashed):
        crash.submit(_reqs(psched)[2])


# ============================================================== failover
@pytest.fixture(scope="module")
def baseline(params):
    jp, _ = params
    eng = JEngine(JCFG, jp, n_slots=4, max_len=64, block_size=4,
                  num_blocks=64, prefix_cache=False)
    done = {}
    eng.on_complete = lambda r: done.setdefault(r.request_id, list(r.tokens))
    for r in _reqs(jsched):
        eng.submit(r)
    eng.run_until_drained()
    return done


def _drained(eng):
    alloc = eng.cm.alloc
    assert alloc.blocks_in_use == 0
    assert all(not s.active for s in eng.cm.slots)
    assert len(alloc.free) == len(set(alloc.free)) == eng.cm.num_blocks - 1


@pytest.mark.parametrize("spill_kv", [True, False])
def test_failover_streams_equal_the_uninterrupted_run(params, baseline,
                                                      spill_kv):
    """Replica A crashes (injected, at tick entry) once every request is
    decoding; ``evacuate`` empties it, B ``adopt``s each spilled session
    (or, without KV, replays it from the folded prompt) and takes the
    queue.  Every stream equals the JAX engine's uninterrupted one."""
    _, pp = params
    a, b = _engine(pp), _engine(pp)
    done = {}
    for e in (a, b):
        e.on_complete = lambda r: done.setdefault(r.request_id, r)
    reqs = _reqs(psched)
    for r in reqs[:3]:
        a.submit(r)
    while not (len(a.live) == 3 and all(r.tokens for r in a.live.values())):
        a.tick()
    a.faults = FaultInjector([FaultSpec(FaultKind.CRASH, at_tick=2)],
                             seed=0).bind("t", 0)
    a.tick()
    a.submit(reqs[3])                     # still queued when A dies
    with pytest.raises(ReplicaCrashed):
        a.tick()
    queued, inflight = a.evacuate(spill_kv=spill_kv)
    assert [r.request_id for r in queued] == ["r3"] and len(inflight) == 3
    migrated = 0
    for req, spilled in inflight:
        assert (spilled is not None) == (spill_kv and bool(req.tokens))
        if spilled is not None and b.adopt(req, spilled):
            migrated += 1
            continue
        req.fold_for_replay()
        b.submit(req)
    for req in queued:
        b.submit(req)
    b.run_until_drained()
    assert {rid: r.tokens for rid, r in done.items()} == baseline
    assert all(r.error is None for r in done.values())
    assert migrated == b.stats.adopted_sessions == a.stats.spilled_sessions
    assert (migrated > 0) == spill_kv
    assert a.stats.host_syncs == a.stats.ticks + a.stats.spill_syncs
    assert b.stats.host_syncs == b.stats.ticks
    _drained(a)
    _drained(b)
