"""Port parity: the torch ``DeviceStore`` (``repro_torch.core.devstore``)
against the JAX package's, and the engines' ``devstore`` / ``kv_key``
bridge, on the CPU.

The scenarios of ``tests/test_devstore_retention.py`` and of the device
store tests in ``tests/test_fastpath_devstore.py`` drive both stores
through the same puts and gets; versions, retention, time-travel reads,
the LRU, ``nbytes``, the donate counters, ``remove_prefix`` and snapshot
values must come out equal.  Then a JAX engine pair and a port engine pair
publish their paged pools into one store each through ticks, a failover
spill and adoptions: every key ends at the same version in both packages
(ticks + adoptions), and the port's stored leaves are the engine's pool
tensors themselves.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as J
from repro.core.devstore import DeviceStore as JStore
from repro.core.pools import Persistence as JPersistence
from repro.core.pools import PoolSpec as JPoolSpec
from repro.serving import faults as jfaults
from repro.serving import scheduler as jsched
from repro.serving.engine import ServeEngine as JEngine
from repro_torch.analysis.sanitizer import LockOrderTracker, SyncSiteSanitizer
import repro_torch.models as P
from repro_torch.core import DeviceStore
from repro_torch.core.pools import Persistence, PoolSpec
from repro_torch.serving import faults as pfaults
from repro_torch.serving import scheduler as psched
from repro_torch.serving.engine import ServeEngine

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


class _Jax:
    """The JAX store and its arrays."""
    PoolSpec, Persistence = JPoolSpec, JPersistence

    @staticmethod
    def store(**kw):
        return JStore(jax.make_mesh((1, 1), ("data", "model")), **kw)

    @staticmethod
    def arr(a):
        return jnp.asarray(a)

    @staticmethod
    def leaves(tree):
        return jax.tree.leaves(tree)


class _Port:
    """The port's store (on the CPU) and its tensors."""
    PoolSpec, Persistence = PoolSpec, Persistence

    @staticmethod
    def store(**kw):
        return DeviceStore("cpu", **kw)

    @staticmethod
    def arr(a):
        return torch.from_numpy(np.array(a))

    @staticmethod
    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in _Port.leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in _Port.leaves(v)]
        return [tree]


def _val(x):
    """A stored value as nested lists (None stays None)."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _val(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_val(v) for v in x]
    return np.asarray(x).tolist()


def _full(B, shape, v):
    return B.arr(np.full(shape, v, np.float32))


# ------------------------------------------------------------- scenarios
def volatile_retention(B):
    ds = B.store(keep_versions=2)
    ds.create_pool(B.PoolSpec(path="/v"))
    for i in range(5):
        ds.put("/v/x", _full(B, (2,), i))
    return [list(ds._entries["/v/x"].versions), ds.latest_version("/v/x"),
            *(_val(ds.get("/v/x", version=v)) for v in (2, 3, 4))]


def keep_one(B):
    ds = B.store(keep_versions=1)
    ds.create_pool(B.PoolSpec(path="/v"))
    for i in range(3):
        ds.put("/v/x", _full(B, (2,), i))
    return [list(ds._entries["/v/x"].versions),
            _val(ds.get("/v/x", version=0))]


def persistent_keeps_every_version(B):
    ds = B.store(keep_versions=1)
    ds.create_pool(B.PoolSpec(path="/p",
                              persistence=B.Persistence.PERSISTENT))
    for i in range(4):
        ds.put("/p/x", _full(B, (2,), i))
    return [list(ds._entries["/p/x"].versions),
            *(_val(ds.get("/p/x", version=v)) for v in range(4))]


def time_travel(B):
    ds = B.store(keep_versions=2)
    ds.create_pool(B.PoolSpec(path="/v"))
    stamps = []
    for i in range(4):
        ds.put("/v/x", _full(B, (1,), i))
        stamps.append(ds._entries["/v/x"].timestamps[i])
    return [_val(ds.get_time("/v/x", t)) for t in stamps] + [
        _val(ds.get_time("/v/x", stamps[0] - 1)),
        _val(ds.get_time("/nope", stamps[-1]))]


def lru_budget(B):
    ds = B.store(lru_bytes=2 * 16)
    ds.create_pool(B.PoolSpec(path="/v"))
    for k in ("a", "b", "c"):
        ds.put(f"/v/{k}", _full(B, (4,), 0))
    log = []
    for k in ("a", "b", "c"):
        ds.get(f"/v/{k}")
        log.append([f"/v/{j}" in ds.lru for j in "abc"] + [ds.lru.nbytes])
    return log


def tree_donate(B):
    ds = B.store(keep_versions=1)
    ds.create_pool(B.PoolSpec(path="/kv"))
    tree = {"k": _full(B, (4, 2), 0), "v": (_full(B, (3,), 1),
                                            B.arr(np.arange(2.0,
                                                            dtype=np.float32)))}
    stored = ds.put("/kv/pool", tree, donate=True)
    same = all(a is b for a, b in zip(B.leaves(stored), B.leaves(tree)))
    return [same, _val(ds.get("/kv/pool")), ds.nbytes(),
            ds.donate_hits, ds.donate_misses, _val(ds.snapshot("/kv"))]


def tree_copy(B):
    ds = B.store()
    ds.create_pool(B.PoolSpec(path="/kv"))
    host = {"a": np.arange(4.0, dtype=np.float32)}
    stored = ds.put("/kv/pool", host)
    missed = ds.put("/kv/pool", host, donate=True)
    return [type(stored["a"]) is type(B.arr(np.zeros(1))),
            stored["a"] is not missed["a"], _val(stored),
            ds.donate_hits, ds.donate_misses, ds.latest_version("/kv/pool")]


def versions_keep_three(B):
    ds = B.store(keep_versions=3)
    ds.create_pool(B.PoolSpec(path="/w", persistence=B.Persistence.VOLATILE,
                              device_axes=(None, None)))
    for i in range(4):
        ds.put("/w/m", _full(B, (2, 2), i))
    return [ds.latest_version("/w/m"),
            *(_val(ds.get("/w/m", version=v)) for v in range(5))]


def zero_copy(B):
    ds = B.store()
    ds.create_pool(B.PoolSpec(path="/w", device_axes=(None,)))
    arr = B.arr(np.arange(4.0, dtype=np.float32))
    return [ds.put("/w/x", arr, donate=True) is arr, ds.donate_hits,
            ds.donate_misses]


def snapshot_persistent(B):
    ds = B.store()
    ds.create_pool(B.PoolSpec(path="/ckpt",
                              persistence=B.Persistence.PERSISTENT,
                              device_axes=(None,)))
    ds.put("/ckpt/a", B.arr(np.arange(3.0, dtype=np.float32)))
    ds.put("/ckpt/b", _full(B, (2,), 1))
    ds.create_pool(B.PoolSpec(path="/other"))
    ds.put("/other/c", _full(B, (1,), 2))
    snap = ds.snapshot("/ckpt")
    return [sorted(snap), _val(snap), ds.nbytes()]


def remove_prefix_per_component(B):
    ds = B.store()
    ds.create_pool(B.PoolSpec(path="/kv"))
    for k in ("/kv/light/replica0/pool", "/kv/light/replica1/pool",
              "/kv/light2/replica0/pool", "/kv/light"):
        ds.put(k, _full(B, (2,), 1))
    removed = ds.remove_prefix("/kv/light/")
    return [removed, sorted(ds.keys()), ds.latest_version("/kv/light"),
            ds.nbytes(), _val(ds.get("/kv/light2/replica0/pool")),
            ds.remove_prefix("/kv/none")]


def unknown_pool(B):
    ds = B.store()
    with pytest.raises(KeyError, match="no device pool"):
        ds.put("/nowhere/x", _full(B, (1,), 0))
    return [ds.keys(), ds.get("/nowhere/x"), ds.latest_version("/x")]


SCENARIOS = [volatile_retention, keep_one, persistent_keeps_every_version,
             time_travel, lru_budget, tree_donate, tree_copy,
             versions_keep_three, zero_copy, snapshot_persistent,
             remove_prefix_per_component, unknown_pool]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_store_matches_the_jax_store(scenario):
    assert scenario(_Port) == scenario(_Jax)


# ------------------------------------------------------- port boundaries
def test_store_needs_the_card_unless_told_otherwise():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceStore()
    assert DeviceStore("cpu").device == torch.device("cpu")


def test_register_sharding_takes_one_device():
    ds = DeviceStore("cpu")
    ds.create_pool(PoolSpec(path="/kv"))
    ds.register_sharding("/kv/a", "cpu")
    assert ds.sharding_for("/kv/a") == torch.device("cpu")
    t = torch.zeros(2)
    assert ds.put("/kv/a", t, donate=True) is t and ds.donate_misses == 0
    # a list of device names is no placement: a tree registered for a key
    # is one of launch.sharding.Placements (tests/test_torch_sharding.py)
    for placement in (["cpu", "cpu"], ("cpu",)):
        with pytest.raises(TypeError, match="Placement"):
            ds.register_sharding("/kv/b", placement)
    ds.remove_prefix("/kv/a")
    assert ds.sharding_for("/kv/a") == ds.device


def test_snapshot_upcasts_what_numpy_lacks_exactly():
    """bf16 and fp8 leaves come back as their exact f32 values; int8 and
    f32 keep their dtype."""
    ds = DeviceStore("cpu")
    ds.create_pool(PoolSpec(path="/kv"))
    x = torch.linspace(-3, 3, 17)
    tree = [{"bf16": x.to(torch.bfloat16), "fp8": x.to(torch.float8_e4m3fn),
             "i8": torch.arange(-8, 9, dtype=torch.int8), "f32": x}]
    ds.put("/kv/pool", tree, donate=True)
    (snap,) = ds.snapshot("/kv").values()
    got = snap[0]
    assert {k: v.dtype for k, v in got.items()} == {
        "bf16": np.float32, "fp8": np.float32, "i8": np.int8,
        "f32": np.float32}
    for k, leaf in tree[0].items():
        np.testing.assert_array_equal(got[k], leaf.float().numpy()
                                      if k in ("bf16", "fp8")
                                      else leaf.numpy())


# ================================================ the engines' publishes
_CFG = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=128, dtype="float32",
            q_chunk=16)                          # tests/test_faults.py:26
JCFG, PCFG = J.ModelConfig(**_CFG), P.ModelConfig(**_CFG)


@pytest.fixture(scope="module")
def params():
    jp = J.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, P.params_from_numpy(jax.tree.map(np.asarray, jp), PCFG,
                                   device="cpu")


def _failover(Engine, sched, faults, params, store):
    """Replica A (``/kv/a``) serves three requests until they decode, then
    crashes at a tick entry; its sessions are spilled and B (``/kv/b``)
    adopts them and serves a fourth.  Both publish into ``store``."""
    rng = np.random.default_rng(7)
    kw = dict(n_slots=4, max_len=64, block_size=4, num_blocks=64,
              prefix_cache=False, devstore=store)
    a, b = (Engine(PCFG if Engine is ServeEngine else JCFG, params,
                   kv_key=f"/kv/{n}", **kw,
                   **({"device": "cpu"} if Engine is ServeEngine else {}))
            for n in "ab")
    reqs = [sched.Request(request_id=f"r{i}", session_key=f"s{i}",
                          prompt=rng.integers(0, 128, 5 + i).astype(np.int32),
                          max_new_tokens=6) for i in range(4)]
    done = {}
    for e in (a, b):
        e.on_complete = lambda r: done.setdefault(r.request_id,
                                                  list(r.tokens))
    for r in reqs[:3]:
        a.submit(r)
    while not (len(a.live) == 3 and all(r.tokens for r in a.live.values())):
        a.tick()
    a.faults = faults.FaultInjector(
        [faults.FaultSpec(faults.FaultKind.CRASH, at_tick=1)]).bind("t", 0)
    with pytest.raises(faults.ReplicaCrashed):
        a.tick()
    queued, inflight = a.evacuate(spill_kv=True)
    assert all(b.adopt(req, spilled) for req, spilled in inflight)
    b.submit(reqs[3])
    b.run_until_drained()
    return (done, {k: store.latest_version(k) for k in sorted(store.keys())},
            [(e.stats.ticks, e.stats.adopted_sessions) for e in (a, b)],
            (store.donate_hits, store.donate_misses)), (a, b)


def test_engine_publishes_match_the_jax_engines(params):
    jp, pp = params
    jds = _Jax.store(keep_versions=1)
    jds.create_pool(JPoolSpec(path="/kv"))
    pds = DeviceStore("cpu", keep_versions=1)
    pds.create_pool(PoolSpec(path="/kv"))
    want, _ = _failover(JEngine, jsched, jfaults, jp, jds)
    got, engines = _failover(ServeEngine, psched, pfaults, pp, pds)
    assert got == want
    _, versions, counts, (hits, misses) = got
    # construction publishes version 0; each tick and adoption one more
    assert versions == {f"/kv/{n}": t + a
                        for n, (t, a) in zip("ab", counts)}
    assert counts[1][1] == 3 and misses == 0
    for n, eng in zip("ab", engines):
        stored = pds.get(f"/kv/{n}")
        assert stored is eng.cm.pools
        assert [t.data_ptr() for layer in stored for t in layer.values()] \
            == [t.data_ptr() for layer in eng.cm.pools
                for t in layer.values()]
