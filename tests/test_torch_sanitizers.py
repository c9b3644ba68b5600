"""The port's runtime sanitizers (``repro_torch.analysis.sanitizer``).

The cases of ``tests/test_lock_sanitizer.py`` on the port's lock-order
tracker (keyed on ``repro_torch.``): an inverted acquisition order is
reported although no deadlock happened, and the port's ``PersistentLog``
runs clean under it.  Then the torch sync-site sanitizer: a host transfer
(``Tensor.cpu`` / ``.item`` / ``.tolist`` / ``.to(<cpu>)`` of a device
tensor, ``torch.cuda.synchronize``) from a fast-path frame other than
``ServeEngine._to_host`` is caught whatever the tensor's device, the sync
site and the allowlisted offline helpers are let through, calls outside
the fast path pass untouched, and a served run of the port's engine on the
CPU is clean.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.analysis.sanitizer import (OFFLINE_HELPERS, LockOrderTracker,
                                            SyncSiteSanitizer, TrackedLock)
from repro_torch.core.log import PersistentLog

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# lock-order tracker
# --------------------------------------------------------------------------

def test_inverted_acquisition_order_is_detected():
    tracker = LockOrderTracker()
    a = tracker.wrap(name="A")
    b = tracker.wrap(name="B")
    with a:
        with b:
            pass
    # the reverse nesting: with another thread interleaving, this deadlocks
    with b:
        with a:
            pass
    assert len(tracker.violations) == 1
    assert "lock-order inversion" in tracker.violations[0]
    assert "A" in tracker.violations[0] and "B" in tracker.violations[0]


def test_consistent_acquisition_order_is_clean():
    tracker = LockOrderTracker()
    a = tracker.wrap(name="A")
    b = tracker.wrap(name="B")
    for _ in range(3):
        with a:
            with b:
                pass
    assert tracker.violations == []


def test_three_lock_cycle_is_detected():
    tracker = LockOrderTracker()
    a, b, c = (tracker.wrap(name=n) for n in "ABC")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with c:
        with a:
            pass           # closes A -> B -> C -> A
    assert len(tracker.violations) == 1
    assert "inversion" in tracker.violations[0]


def test_self_deadlock_fails_fast():
    tracker = LockOrderTracker()
    a = tracker.wrap(name="A")
    a.acquire()
    with pytest.raises(RuntimeError, match="self-deadlock"):
        a.acquire()
    assert any("self-deadlock" in v for v in tracker.violations)
    a.release()


def test_reentrant_reacquire_is_allowed():
    tracker = LockOrderTracker()
    r = tracker.wrap(name="R", reentrant=True)
    with r:
        with r:
            pass
    assert tracker.violations == []


def test_install_wraps_only_matching_modules():
    tracker = LockOrderTracker()
    tracker.install(module_prefixes=("tests.", "test_"))
    try:
        ours = threading.Lock()          # created from this test module
    finally:
        tracker.uninstall()
    assert isinstance(ours, TrackedLock)
    assert not isinstance(threading.Lock(), TrackedLock)   # uninstalled
    # the default prefix (the port's modules) leaves test-module locks
    # native, and wraps the port's
    tracker2 = LockOrderTracker()
    tracker2.install()
    try:
        native = threading.Lock()
        ns = {"__name__": "repro_torch.core.log", "threading": threading}
        exec("def make():\n    return threading.Lock()", ns)
        port = ns["make"]()
    finally:
        tracker2.uninstall()
    assert not isinstance(native, TrackedLock)
    assert isinstance(port, TrackedLock)


def test_install_detects_inversion_through_threading_api():
    tracker = LockOrderTracker()
    tracker.install(module_prefixes=("tests.", "test_"))
    try:
        a = threading.Lock()
        b = threading.Lock()
    finally:
        tracker.uninstall()
    with a, b:
        pass
    with b, a:
        pass
    assert len(tracker.violations) == 1


def test_persistent_log_runs_clean_under_tracker(tmp_path):
    """End-to-end: the port's write-back thread + append path produce no
    violations, and its locks are the tracker's."""
    tracker = LockOrderTracker()
    tracker.install()
    try:
        log = PersistentLog(str(tmp_path / "wal.log"))
        tracked = [v for v in vars(log).values()
                   if isinstance(v, TrackedLock)]
        for i in range(8):
            log.append(f"k{i % 3}", f"payload-{i}".encode())
        log.close()
    finally:
        tracker.uninstall()
    assert tracked
    assert tracker.violations == []


# --------------------------------------------------------------------------
# sync-site sanitizer
# --------------------------------------------------------------------------

def _frame_fn(module_name, fn_name, body):
    """A function whose frame claims to live in ``module_name``."""
    ns = {"__name__": module_name, "torch": torch}
    exec(f"def {fn_name}(t):\n    return {body}", ns)
    return ns[fn_name]


@pytest.fixture
def sync():
    san = SyncSiteSanitizer()
    san.install()
    try:
        yield san
    finally:
        san.uninstall()


@pytest.mark.parametrize("body,what", [
    ("t.cpu()", "Tensor.cpu"), ("t.sum().item()", "Tensor.item"),
    ("t.tolist()", "Tensor.tolist")])
@pytest.mark.parametrize("module", ["repro_torch.serving.scheduler",
                                    "repro_torch.models.lm",
                                    "repro_torch.kernels.ssd.ops"])
def test_host_transfer_from_wrong_fastpath_site_is_flagged(sync, body, what,
                                                           module):
    _frame_fn(module, "_peek", body)(torch.zeros(2))   # a CPU tensor too
    assert len(sync.violations) == 1
    assert f"{what} called from {module}::_peek" in sync.violations[0]


def test_transfer_to_the_cpu_of_a_device_tensor_is_flagged(sync):
    meta = torch.empty(2, device="meta")      # not on the host
    with pytest.raises(NotImplementedError):
        _frame_fn("repro_torch.serving.engine", "_tick", 't.to("cpu")')(meta)
    assert len(sync.violations) == 1
    assert "Tensor.to(<cpu>)" in sync.violations[0]
    # a CPU tensor moved to the engine's own (CPU) device moves nothing
    _frame_fn("repro_torch.serving.kvcache", "to_device",
              "t.to(torch.device('cpu'), non_blocking=True)")(torch.zeros(2))
    assert len(sync.violations) == 1


def test_cuda_synchronize_from_the_fast_path_is_flagged(sync):
    fn = _frame_fn("repro_torch.kernels.flash_attention.ops",
                   "flash_attention", "torch.cuda.synchronize()")
    if torch.cuda.is_available():
        fn(None)
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            fn(None)
    assert len(sync.violations) == 1
    assert "torch.cuda.synchronize" in sync.violations[0]


def test_the_sync_site_and_offline_helpers_are_allowed(sync):
    _frame_fn("repro_torch.serving.engine", "_to_host",
              "t.cpu().numpy()")(torch.zeros(2))
    for (module, fn) in OFFLINE_HELPERS:
        _frame_fn(module, fn, "t.tolist()")(torch.zeros(2))
    assert sync.violations == []
    assert all(len(reason.split()) >= 3 for reason in OFFLINE_HELPERS.values())


def test_host_transfer_outside_fastpath_is_allowed(sync):
    torch.zeros(2).cpu()                             # test code: fine
    _frame_fn("repro_torch.training.train", "pull", "t.sum().item()")(
        torch.zeros(2))
    _frame_fn("repro_torch.core.devstore", "_to_numpy", "t.cpu()")(
        torch.zeros(2))
    assert sync.violations == []


def test_uninstall_restores_torch():
    before = (torch.Tensor.cpu, torch.Tensor.item, torch.Tensor.tolist,
              torch.Tensor.to, torch.cuda.synchronize)
    san = SyncSiteSanitizer()
    san.install()
    assert torch.Tensor.cpu is not before[0]
    san.uninstall()
    assert (torch.Tensor.cpu, torch.Tensor.item, torch.Tensor.tolist,
            torch.Tensor.to, torch.cuda.synchronize) == before
    assert "cpu" not in vars(torch.Tensor)
    _frame_fn("repro_torch.serving.scheduler", "_peek", "t.cpu()")(
        torch.zeros(2))
    assert san.violations == []


def test_served_run_of_the_port_engine_is_clean(sync):
    """The paged engine on the CPU pulls only in ``_to_host`` (K1's plain
    version, the CPU route, is an allowlisted helper); a stray pull slipped
    into its tick is caught."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import engine as eng_mod
    from repro_torch.serving.scheduler import Request

    cfg = get_config("gemma2-9b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    engine = eng_mod.ServeEngine(cfg, params, n_slots=2, max_len=32,
                                 device="cpu")
    for i in range(2):
        engine.submit(Request(request_id=f"r{i}", session_key=f"s{i}",
                              prompt=np.arange(3 + i, dtype=np.int32),
                              max_new_tokens=3))
    engine.run_until_drained()
    assert sync.violations == []
    assert engine.stats.host_syncs == engine.stats.ticks

    stray = _frame_fn("repro_torch.serving.engine", "_tick_mixed",
                      "t.sum().item()")
    orig = eng_mod.ServeEngine._tick_mixed
    eng_mod.ServeEngine._tick_mixed = \
        lambda self: (stray(torch.ones(1)), orig(self))[1]
    try:
        engine.submit(Request(request_id="r2", session_key="s0",
                              prompt=np.arange(4, dtype=np.int32),
                              max_new_tokens=2))
        engine.run_until_drained()
    finally:
        eng_mod.ServeEngine._tick_mixed = orig
    assert sync.violations and all(
        "repro_torch.serving.engine::_tick_mixed" in v
        for v in sync.violations)
