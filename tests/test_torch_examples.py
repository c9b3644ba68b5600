"""The port's example twins (``examples_torch/``) on the CPU.

Each twin runs to ``OK`` at ``--device cpu`` (``train_lm`` at the smallest
``--steps/--batch/--seq`` under which its own assertion, a falling loss,
holds).  Then the twins are held against the JAX package on the same
numbers:

- ``serve_lm``: the JAX example itself runs (its engine and requests
  recorded); the twin's ``make_engine`` / ``submit_requests`` serve the
  same requests with the JAX example's params carried across by
  ``params_from_numpy``: equal greedy streams, prefills, tokens, ticks and
  host syncs.
- ``serve_cluster``: a JAX ``ServeNode`` and the twin's ``deploy_tiers``
  on a port ``ServeNode``, with the same params, run the twin's
  ``chat_sessions``: the same replica pins each session, the same
  ``prefix_hit_tokens``, and each light tier keeps ``host_syncs ==
  ticks``; the heavy tiers then serve the same prompts to equal streams,
  each keeping ``host_syncs == decode_ticks + prefill_batches``.
- ``quickstart``, ``smart_farming``, ``collision_detection``: the JAX
  example's own vertex functions are taken from its ``deploy`` call and
  fed the same objects as the twin's (the models' weights drawn as the
  JAX example draws them): equal emitted outputs.
"""
import contextlib
import importlib.util
import io
import threading
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as J
from repro.configs.registry import get_config as jget_config
from repro.core.pools import DispatchPolicy as JPolicy
from repro.serving import cluster as jcluster
import repro_torch.models as P
from repro_torch.configs.registry import get_config
from repro_torch.serving.cluster import ServeNode

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TWINS = ("quickstart", "smart_farming", "collision_detection", "serve_lm",
         "serve_cluster", "train_lm")
# the smallest run at which train_lm's own assertion (the last loss below
# the first) holds
TRAIN_ARGS = ["--steps", "2", "--batch", "1", "--seq", "1"]


def _load(path: Path, name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _twin(name: str) -> types.ModuleType:
    return _load(ROOT / "examples_torch" / f"{name}.py", f"_twin_{name}")


def _jax_example(name: str) -> types.ModuleType:
    return _load(ROOT / "examples" / f"{name}.py", f"_jax_example_{name}")


def _to_port(jparams, cfg):
    return P.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")


@pytest.mark.parametrize("name", TWINS)
def test_twin_runs_to_ok(name):
    argv = ["--device", "cpu"] + (TRAIN_ARGS if name == "train_lm" else [])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _twin(name).main(argv)
    assert out.getvalue().splitlines()[-1] == "OK", out.getvalue()


# ------------------------------------------------------------- serve_lm
def test_serve_lm_matches_the_jax_example():
    jmod = _jax_example("serve_lm")
    seen = {}

    class Recording(jmod.ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["engine"], seen["reqs"] = self, []

        def submit(self, req):
            seen["reqs"].append(req)
            super().submit(req)

    jmod.ServeEngine = Recording
    with contextlib.redirect_stdout(io.StringIO()) as out:
        jmod.main()
    assert out.getvalue().splitlines()[-1] == "OK"
    want = seen["engine"]

    twin = _twin("serve_lm")
    cfg = get_config("gemma2-9b", smoke=True)
    eng = twin.make_engine(cfg, _to_port(want.params, cfg), "cpu")
    reqs = twin.submit_requests(eng, cfg.vocab_size, len(seen["reqs"]),
                                np.random.default_rng(0))
    eng.run_until_drained()
    assert [r.request_id for r in reqs] == \
        [r.request_id for r in seen["reqs"]]
    assert [list(r.tokens) for r in reqs] == \
        [list(r.tokens) for r in seen["reqs"]]
    for key in ("prefills", "tokens_out", "ticks", "host_syncs"):
        assert getattr(eng.stats, key) == getattr(want.stats, key), key
    assert eng.stats.host_syncs == eng.stats.ticks


# -------------------------------------------------------- serve_cluster
def test_serve_cluster_sessions_match_the_jax_node():
    twin = _twin("serve_cluster")
    light_j = jget_config("gemma2-9b", smoke=True)
    heavy_j = jget_config("mamba2-1.3b", smoke=True)
    light_p = get_config("gemma2-9b", smoke=True)
    heavy_p = get_config("mamba2-1.3b", smoke=True)
    jl = J.init_params(jax.random.PRNGKey(0), light_j)
    jh = J.init_params(jax.random.PRNGKey(1), heavy_j)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, heavy_p.vocab_size, (n,)).astype(np.int32)
               for n in (5, 9, 5)]
    runs = {}
    with jcluster.ServeNode(n_workers=2) as node:
        light = node.deploy("light", light_j, jl, n_replicas=2, n_slots=4,
                            max_len=64, policy=JPolicy.FIFO)
        heavy = node.deploy("heavy", heavy_j, jh, n_replicas=2, n_slots=4,
                            max_len=64)
        runs["jax"] = _sessions_then_heavy(twin, node, light, heavy,
                                           light_p.vocab_size, prompts)
    with ServeNode(n_workers=2, device="cpu") as node:
        light, heavy = twin.deploy_tiers(node, light_p, _to_port(jl, light_p),
                                         heavy_p, _to_port(jh, heavy_p))
        runs["port"] = _sessions_then_heavy(twin, node, light, heavy,
                                            light_p.vocab_size, prompts)
    want, got = runs["jax"], runs["port"]
    assert got["replicas"] == want["replicas"]
    assert all(len(r) == 1 for r in got["replicas"].values())
    for key in ("prefix_hit_tokens", "prompt_tokens",
                "per_replica_requests", "requests"):
        assert got["stats"][key] == want["stats"][key], key
    assert got["stats"]["prefix_hit_tokens"] > 0
    assert got["heavy"] == want["heavy"]
    for run in runs.values():
        st, hs = run["stats"], run["heavy_stats"]
        assert st["host_syncs"] == st["ticks"]
        assert hs["host_syncs"] == hs["decode_ticks"] + hs["prefill_batches"]


def _sessions_then_heavy(twin, node, light, heavy, vocab, prompts) -> dict:
    run = twin.chat_sessions(node, light, vocab, np.random.default_rng(0))
    for i, p in enumerate(prompts):
        heavy.submit(f"h{i % 2}", f"h{i}", p, max_new_tokens=4)
    node.run_until_drained()
    run["heavy"] = [list(map(int, heavy.result(f"h{i}")))
                    for i in range(len(prompts))]
    run["heavy_stats"] = heavy.stats()
    return run


# --------------------------------------------------- the DFG examples
class _Deployed(Exception):
    pass


def _jax_lambdas(name: str) -> dict:
    """The vertex functions the JAX example deploys, taken from its
    ``deploy`` call (the example stops there)."""
    jmod = _jax_example(name)
    got = {}

    class Capture:
        def __init__(self, *a, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def deploy(self, dfg, lambdas):
            got.update(lambdas)
            raise _Deployed

    jmod.CascadeService = Capture
    with pytest.raises(_Deployed):
        jmod.main()
    return got


def _emits(fn, key, payload) -> list:
    out = []
    ctx = types.SimpleNamespace(
        emit=lambda suffix, value, trigger=False: out.append(
            (suffix, value, trigger)))
    fn(ctx, types.SimpleNamespace(key=key, payload=payload))
    return out


def test_quickstart_vertex_functions_match_the_jax_example():
    want, twin = _jax_lambdas("quickstart"), _twin("quickstart")
    got = {"upper": twin.lam_upper, "reverse": twin.lam_reverse}
    assert set(got) == set(want)
    for payload in (b"hello cascade", b"", b"MiXeD 123"):
        for name in want:
            assert _emits(got[name], "/qs/in/greeting", payload) == \
                _emits(want[name], "/qs/in/greeting", payload)


def _torch_weights(arrays: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


def test_smart_farming_vertex_functions_match_the_jax_example():
    want = _jax_lambdas("smart_farming")
    key = jax.random.PRNGKey(0)        # examples/smart_farming.py's draws
    w = {"w_f1": jax.random.normal(key, (768, 64)) / 28.0,
         "w_f2": jax.random.normal(key, (64, 2)) / 8.0,
         "w_b1": jax.random.normal(key, (768, 128)) / 28.0,
         "w_b2": jax.random.normal(key, (128, 5)) / 12.0}
    twin = _twin("smart_farming")
    got = twin.make_lambdas(*twin.make_models(_torch_weights(w)), {},
                            threading.Event())
    assert set(got) == set(want)
    frames = np.random.default_rng(3).standard_normal(
        (16, 1, 768)).astype(np.float32)
    scores = set()
    for i, frame in enumerate(frames):
        for name in ("filter", "bcs"):
            a = _emits(got[name], f"/sf/x/frame{i}", frame)
            b = _emits(want[name], f"/sf/x/frame{i}", frame)
            assert len(a) == len(b) == 1
            (sa, va, ta), (sb, vb, tb) = a[0], b[0]
            assert (sa, ta) == (sb, tb)
            if name == "filter":
                assert va is frame and vb is frame
            else:
                assert va == vb
                scores.add(va["score"])
    assert len(scores) > 1                 # the frames are told apart


def test_collision_detection_vertex_functions_match_the_jax_example():
    want = _jax_lambdas("collision_detection")
    key = jax.random.PRNGKey(1)        # examples/collision_detection.py's
    w = {"w_mot": jax.random.normal(key, (512, 64)) / 23.0,
         "w_ynet": jax.random.normal(key, (16, 48)) / 4.0}
    twin = _twin("collision_detection")
    got = twin.make_lambdas(*twin.make_models(_torch_weights(w)), {},
                            threading.Event())
    assert set(got) == set(want)
    frame = np.random.default_rng(5).standard_normal(
        (1, 512)).astype(np.float32)
    for agents in (5, 10, 15):
        payload = {"frame": frame, "agents": agents}
        np.random.seed(agents)
        (a,) = _emits(got["mot"], "/rcd/frames/f0", payload)
        np.random.seed(agents)
        (b,) = _emits(want["mot"], "/rcd/frames/f0", payload)
        assert a[0] == b[0] and a[2] == b[2]
        np.testing.assert_array_equal(a[1], b[1])
        tracks = a[1]
        (a,) = _emits(got["ynet"], "/rcd/tracks/f0", tracks)
        (b,) = _emits(want["ynet"], "/rcd/tracks/f0", tracks)
        assert a[0] == b[0] and a[2] == b[2]
        np.testing.assert_allclose(a[1], np.asarray(b[1]), rtol=1e-5,
                                   atol=1e-5)
        preds = a[1]
        (a,) = _emits(got["detect"], "/rcd/preds/f0", preds)
        (b,) = _emits(want["detect"], "/rcd/preds/f0", preds)
        assert a == b
    # three agents on one path: every pair collides
    crafted = np.zeros((3, 48), np.float32)
    assert _emits(got["detect"], "/rcd/preds/f1", crafted) == \
        _emits(want["detect"], "/rcd/preds/f1", crafted) == \
        [("f1", 3, False)]
    # the models themselves, on the same frame
    mot, _ = twin.make_models(_torch_weights(w))
    np.testing.assert_allclose(
        mot(frame).numpy(), np.asarray(jnp.tanh(frame @ w["w_mot"])),
        rtol=1e-5, atol=1e-5)
