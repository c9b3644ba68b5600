"""Port parity: Cascade's multi-tenant serving layer (``ServeNode``,
``ModelDeployment``, ``CascadeRoute``, ``ServeCluster``) on the CPU.

1. The JAX package's own cluster scenarios — every test of
   ``tests/test_serve_node.py``, ``tests/test_serve_cluster.py``,
   ``tests/test_faults.py``, ``tests/test_preempt_resume.py`` and
   ``tests/test_scheduler_slo.py`` — read from those files and run against
   the port: every ``repro.`` import points at ``repro_torch.``, every
   ``ServeNode`` / ``ServeCluster`` / ``ServeEngine`` gets
   ``device="cpu"``, and ``init_params`` makes the JAX package's params
   and carries them across with ``params_from_numpy``, so each scenario
   serves the weights it serves in the JAX suite.  Each runs under the
   port's lock-order tracker and sync-site sanitizer.
2. A JAX ``ServeNode`` and a port ``ServeNode(device="cpu")`` hosting
   gemma2-9b SMOKE (paged) and mamba2-1.3b SMOKE (dense) at f32, with the
   same params: FIFO chat sessions, then a cascade whose gate always trips
   and one whose gate never trips.  Per request id the greedy streams and
   the replica each landed on are equal, and so are the prefix-hit and
   escalation counters and every ``/kv`` key's latest version.

Every drain is bounded (``run_until_drained(timeout_s=...)``), so a hang
fails in seconds.
"""
import ast
import dataclasses
import inspect
import math
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.models as J
from repro.configs.registry import get_config as jget_config
from repro.core.pools import DispatchPolicy as JPolicy
from repro.serving import cluster as jcluster
from repro_torch.analysis.sanitizer import LockOrderTracker, SyncSiteSanitizer
import repro_torch.models as P
from repro_torch.configs.registry import get_config
from repro_torch.core.pools import DispatchPolicy
from repro_torch.serving import cluster as pcluster

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
SOURCES = ("test_serve_node", "test_serve_cluster", "test_faults",
           "test_preempt_resume", "test_scheduler_slo")
ON_DEVICE = ("ServeNode", "ServeCluster", "ServeEngine")
DRAIN_S = 60.0


def init_params(key, cfg):
    """The JAX package's params for ``cfg`` (a port config), on the port."""
    jcfg = J.ModelConfig(**dataclasses.asdict(cfg))
    tree = jax.tree.map(np.asarray, J.init_params(key, jcfg))
    return P.params_from_numpy(tree, cfg, device="cpu")


class _ToPort(ast.NodeTransformer):
    """``repro.`` imports → ``repro_torch.``; the serving entry points run
    on the CPU; fixture decorators dropped (the runner resolves them)."""

    def __init__(self) -> None:
        self.fixtures: set[str] = set()

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        if mod == "repro" or mod.startswith("repro."):
            node.module = "repro_torch" + mod[len("repro"):]
            node.names = [a for a in node.names if a.name != "init_params"]
            if not node.names:
                return None
        return node

    def visit_FunctionDef(self, node):
        self.generic_visit(node)
        kept = []
        for d in node.decorator_list:
            target = d.func if isinstance(d, ast.Call) else d
            if isinstance(target, ast.Attribute) and target.attr == "fixture":
                self.fixtures.add(node.name)
            else:
                kept.append(d)
        node.decorator_list = kept
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        name = getattr(node.func, "id", getattr(node.func, "attr", None))
        if name in ON_DEVICE and not any(k.arg == "device"
                                         for k in node.keywords):
            node.keywords.append(ast.keyword(arg="device",
                                             value=ast.Constant("cpu")))
        return node


def _load(stem: str) -> tuple[dict, set[str]]:
    """The scenarios of ``tests/<stem>.py``, executed against the port, and
    the names of its fixtures."""
    path = TESTS / f"{stem}.py"
    to_port = _ToPort()
    tree = to_port.visit(ast.parse(path.read_text()))
    ns = {"__name__": f"{stem}_on_the_port", "__file__": str(path),
          "init_params": init_params}
    exec(compile(ast.fix_missing_locations(tree), str(path), "exec"), ns)
    return ns, to_port.fixtures


_SCENARIOS = {stem: _load(stem) for stem in SOURCES}
_FIXTURE_VALUES: dict[tuple[str, str], object] = {}


def _cases():
    for stem, (ns, fixtures) in _SCENARIOS.items():
        for name, fn in ns.items():
            if not (name.startswith("test_") and callable(fn)
                    and name not in fixtures):
                continue
            marks = [m for m in getattr(fn, "pytestmark", [])
                     if m.name == "parametrize"]
            if not marks:
                yield pytest.param(stem, name, {}, id=f"{stem}::{name}")
                continue
            (mark,) = marks
            argname, values = mark.args
            for v in values:
                yield pytest.param(stem, name, {argname: v},
                                   id=f"{stem}::{name}[{v}]")


def _fixture(stem: str, name: str):
    """A source file's module-scoped fixture, made once."""
    key = (stem, name)
    if key not in _FIXTURE_VALUES:
        fn = _SCENARIOS[stem][0][name]
        _FIXTURE_VALUES[key] = fn(**{arg: _fixture(stem, arg) for arg in
                                     inspect.signature(fn).parameters})
    return _FIXTURE_VALUES[key]


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


def test_scenarios_serve_through_the_port():
    for stem, (ns, _) in _SCENARIOS.items():
        mods = {getattr(v, "__module__", "") or "" for v in ns.values()
                if inspect.isclass(v) or inspect.isfunction(v)}
        assert not any(m.split(".")[0] == "repro" for m in mods), (stem, mods)
        assert any(m.startswith("repro_torch.") for m in mods), stem


@pytest.mark.parametrize("stem,name,kwargs", list(_cases()))
def test_reference_scenario_on_the_port(stem, name, kwargs, tmp_path,
                                        monkeypatch):
    ns, fixtures = _SCENARIOS[stem]
    fn = ns[name]
    builtin = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    kwargs = dict(kwargs)
    for arg in inspect.signature(fn).parameters:
        if arg in kwargs:
            continue
        kwargs[arg] = (builtin[arg] if arg in builtin
                       else _fixture(stem, arg))
    fn(**kwargs)


# ============================================== the port's own boundaries
def test_node_needs_the_card_and_leaves_no_thread():
    """``ServeNode()`` runs on the card: without one it raises before any
    upcall thread starts."""
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pcluster.ServeNode(n_workers=2)
    assert threading.active_count() == before


def test_mesh_slices_raise_naming_their_slice():
    """Mesh slices are ported (``tests/test_torch_sharding.py``): a
    deployment takes its slices off the node's free list of logical
    devices (one on the CPU), gives them back at ``stop()``, and a request
    the list cannot cover raises, naming the shortage."""
    cfg = P.ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                        n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                        dtype="float32", q_chunk=16)
    params = P.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    with pcluster.ServeNode(n_workers=1, device="cpu") as node:
        assert len(node._free_devices) == 1
        dep = node.deploy("m", cfg, params, n_replicas=1,
                          devices_per_replica=1)
        assert node._free_devices == []
        assert dep.engines[0].mesh.devices.shape == (1, 1)
        with pytest.raises(ValueError, match="only 0 are available"):
            node.deploy("m2", cfg, params, n_replicas=1,
                        devices_per_replica=1)
        dep.stop()
        assert len(node._free_devices) == 1


# ====================================== a JAX node against a port node
LIGHT, HEAVY = "gemma2-9b", "mamba2-1.3b"


@pytest.fixture(scope="module")
def tenants():
    """(JAX cfg, port cfg, JAX params, port params) per tier, f32 SMOKE,
    embedding rows N(0, 1/d) so random-weight streams vary."""
    out = {}
    for tier, arch, seed in (("light", LIGHT, 0), ("heavy", HEAVY, 1)):
        jcfg, pcfg = jget_config(arch, smoke=True), get_config(arch,
                                                               smoke=True)
        assert jcfg.dtype == pcfg.dtype == "float32"
        jp = J.init_params(jax.random.PRNGKey(seed), jcfg)
        jp["embed"]["table"] = jp["embed"]["table"] * jcfg.d_model ** -0.5
        pp = P.params_from_numpy(jax.tree.map(np.asarray, jp), pcfg,
                                 device="cpu")
        out[tier] = (jcfg, pcfg, jp, pp)
    return out


def _chat_turns(vocab: int):
    """Three sessions × three turns: each turn's prompt is the previous
    prompt, its answer and new user tokens."""
    rng = np.random.default_rng(21)
    return {f"chat{s}": [rng.integers(1, vocab, n).astype(np.int32)
                         for n in (20 + 3 * s, 7, 9)] for s in range(3)}


def _cascade_prompts(vocab: int, n: int = 6):
    """Distinct lengths: each dense prefill is a batch of one in both
    packages, whatever the arrival order."""
    rng = np.random.default_rng(22)
    return {f"q{i}": rng.integers(1, vocab, 9 + 5 * i).astype(np.int32)
            for i in range(n)}


def _serve(mod, policy, tenants, pkg: str):
    """Chat turns on the light tier, then two cascades (gate always / never
    trips); returns what both packages must agree on."""
    idx = 0 if pkg == "jax" else 1
    light_cfg, heavy_cfg = tenants["light"][idx], tenants["heavy"][idx]
    light_p, heavy_p = tenants["light"][2 + idx], tenants["heavy"][2 + idx]
    kw = {} if pkg == "jax" else {"device": "cpu"}
    out = {"streams": {}, "routed": {}}
    with mod.ServeNode(n_workers=2, **kw) as node:
        light = node.deploy("light", light_cfg, light_p, n_replicas=2,
                            n_slots=2, max_len=96, token_budget=16,
                            policy=policy.FIFO)
        heavy = node.deploy("heavy", heavy_cfg, heavy_p, n_replicas=2,
                            n_slots=2, max_len=96)
        history = {s: np.zeros(0, np.int32) for s in _chat_turns(256)}
        for turn in range(3):
            receipts = []
            for s, turns in _chat_turns(256).items():
                history[s] = np.concatenate([history[s], turns[turn]])
                receipts.append(light.submit(s, f"{s}-t{turn}", history[s],
                                             max_new_tokens=5))
            for r in receipts:
                r.wait()
            node.run_until_drained(timeout_s=DRAIN_S)
            for s in history:
                got = light.result(f"{s}-t{turn}")
                history[s] = np.concatenate([history[s], got])
        routes = {}
        for gate, thr in (("always", math.inf), ("never", -math.inf)):
            route = mod.CascadeRoute(light, heavy,
                                     mod.CascadeGate("logprob", thr))
            receipts = [route.submit(f"c-{gate}-{rid}", f"{gate}-{rid}", p,
                                     max_new_tokens=4)
                        for rid, p in _cascade_prompts(256).items()]
            for r in receipts:
                r.wait()
            node.run_until_drained(timeout_s=DRAIN_S)
            st = route.stats()
            routes[gate] = {k: st[k] for k in (
                "requests", "escalated", "gate_trips", "error_failovers",
                "escalation_rate")}
            for rid in _cascade_prompts(256):
                rid = f"{gate}-{rid}"
                out["streams"][f"route:{rid}"] = route.result(rid).tolist()
                out["streams"][f"escalated:{rid}"] = route.escalated(rid)
            light.on_done.remove(route._on_light_done)
        for dep in (light, heavy):
            for rid in list(dep.routed):
                out["routed"][f"{dep.name}:{rid}"] = dep.routed[rid]
                out["streams"][f"{dep.name}:{rid}"] = \
                    dep.result(rid).tolist()
        ls, hs = light.stats(), heavy.stats()
        out["routes"] = routes
        out["light"] = {k: ls[k] for k in ("requests", "prefix_hit_tokens",
                                           "prefix_hits", "tokens_out")}
        out["heavy"] = {k: hs[k] for k in ("requests", "prefix_hit_tokens",
                                           "tokens_out")}
        out["kv"] = {k: node.kv_store().latest_version(k)
                     for k in sorted(node.kv_store().keys())}
        out["ticks"] = [e.stats.ticks for e in light.engines]
        assert ls["host_syncs"] == ls["ticks"]
        assert hs["host_syncs"] == hs["decode_ticks"] + hs["prefill_batches"]
        if pkg == "port":
            ds = node.kv_store()
            assert ds.donate_misses == 0
            for r, eng in enumerate(light.engines):
                stored = ds.get(f"/kv/light/replica{r}/pool")
                assert [t.data_ptr() for layer in stored
                        for t in layer.values()] == \
                    [t.data_ptr() for layer in eng.cm.pools
                     for t in layer.values()]
    return out


def test_two_tenant_node_matches_the_jax_node(tenants):
    want = _serve(jcluster, JPolicy, tenants, "jax")
    got = _serve(pcluster, DispatchPolicy, tenants, "port")
    assert got["streams"] == want["streams"]
    assert got["routed"] == want["routed"]
    assert got["routes"] == want["routes"]
    assert got["light"] == want["light"] and got["heavy"] == want["heavy"]
    assert got["kv"] == want["kv"]
    # the cases the comparison is meant to cover did occur
    assert got["light"]["prefix_hit_tokens"] > 0
    assert got["routes"]["always"]["escalation_rate"] == 1.0
    assert got["routes"]["never"]["escalated"] == 0
    assert got["kv"] == {f"/kv/light/replica{r}/pool": got["ticks"][r]
                         for r in range(2)}
    sessions = {rid.split(":")[1].rsplit("-t", 1)[0]: r
                for rid, r in got["routed"].items()
                if rid.startswith("light:chat")}
    for rid, r in got["routed"].items():
        if rid.startswith("light:chat"):
            assert r == sessions[rid.split(":")[1].rsplit("-t", 1)[0]]


# ===================================== preempt-before-shed, both packages
_TINY = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
             n_kv_heads=2, d_ff=64, vocab_size=128, dtype="float32",
             q_chunk=16)                      # tests/test_preempt_resume.py:20


def _preempt_before_shed(mod, cfg, params, **kw):
    """One replica, one slot, watermark 1, preemption on: a batch request
    decodes; an interactive one from another session is admitted over the
    watermark (its engine evicts the batch victim into the deployment's
    store-backed spill pool and adopts it back later); a second batch turn
    of the first session finds no later-deadline victim and is shed."""
    rng = np.random.default_rng(5)
    prompts = {rid: rng.integers(1, 128, n).astype(np.int32)
               for rid, n in (("b0", 8), ("i0", 4), ("b1", 6))}
    with mod.ServeNode(n_workers=1, **kw) as node:
        dep = node.deploy("light", cfg, params, n_replicas=1, n_slots=1,
                          max_len=48, num_blocks=11, block_size=4,
                          prefix_cache=False, watermark=1, preempt=True)
        dep.submit("a", "b0", prompts["b0"], max_new_tokens=8,
                   slo="batch").wait()
        eng = dep.engines[0]
        while not (eng.live and all(r.tokens for r in eng.live.values())):
            node.step()
        dep.submit("b", "i0", prompts["i0"], max_new_tokens=3,
                   slo="interactive").wait()
        dep.submit("a", "b1", prompts["b1"], max_new_tokens=4,
                   slo="batch").wait()
        node.run_until_drained(timeout_s=DRAIN_S)
        st = dep.stats()
        err = dep.error("b1")
        return ({rid: dep.result(rid).tolist() for rid in prompts},
                err["error"] if err else None,
                {k: st[k] for k in ("preempt_admits", "shed", "preemptions",
                                    "resumes", "spilled_sessions",
                                    "adopted_sessions", "spill_syncs",
                                    "host_syncs", "ticks",
                                    "spill_pool_parked",
                                    "spill_pool_unparked",
                                    "spill_pool_blocks")})


def test_preempt_before_shed_matches_the_jax_node():
    jcfg, pcfg = J.ModelConfig(**_TINY), P.ModelConfig(**_TINY)
    jp = J.init_params(jax.random.PRNGKey(0), jcfg)
    jp["embed"]["table"] = jp["embed"]["table"] * jcfg.d_model ** -0.5
    pp = P.params_from_numpy(jax.tree.map(np.asarray, jp), pcfg,
                             device="cpu")
    want = _preempt_before_shed(jcluster, jcfg, jp)
    got = _preempt_before_shed(pcluster, pcfg, pp, device="cpu")
    assert got == want
    streams, shed, st = got
    assert shed == "shed_overload" and streams["b1"] == []
    assert st["preempt_admits"] == 1 and st["shed"] == 1
    assert st["preemptions"] >= 1 and st["resumes"] >= 1
    assert st["spill_pool_parked"] >= 1 and st["spill_pool_blocks"] == 0
    assert st["host_syncs"] == st["ticks"] + st["spill_syncs"]
