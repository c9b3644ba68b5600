"""The engine's CUDA-graph ticks, on the CPU.

A captured tick reads and writes only buffers whose storage never moves, so
these tests serve whole runs (paged at spec_k 0 and 2, dense on the SSM
configs) and hold the storage of every operand the tick hands its model,
its sampler and its output, tick after tick, with the greedy streams equal
to the JAX engine's.

The capture itself needs the card.  Here ``_FakeGraph`` stands in for
``torch.cuda.CUDAGraph`` with its semantics: capturing runs nothing (what
the captured step wrote, and the draws it took, are put back at
``capture_end``), a replay runs the captured step again, and the kernel
wrappers' Python, which a real replay never runs, counts nothing at a
replay.  Through it the engine's own capture path (``_GraphTick``) runs:
one eager tick, one capture, replays after that, the launch counters
adding the captured counts at each replay, and the sampled path reseeding
the generator the graph reads.
"""
import contextlib
import functools
import weakref

import jax
import numpy as np
import pytest
import torch

import repro.models as J
from repro.configs.registry import get_config as jget_config
from repro.serving import scheduler as jsched
from repro.serving.engine import ServeEngine as JEngine
import repro_torch.models as P
from repro_torch import kernels
from repro_torch.configs.registry import get_config
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import (layer_specs, sample_with_scores,
                                speculative_verify)
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import scheduler as psched
from repro_torch.serving.engine import EngineStats, ServeEngine

torch.set_num_threads(1)

PAGED = dict(n_slots=4, max_len=96, block_size=4, token_budget=8)
DENSE = dict(n_slots=3, max_len=40, paged=False)


# gemma2 and deepseek-moe SMOKE serve paged (speculative or not), the SSM
# configs dense
RUNS = [("gemma2-9b", 0), ("gemma2-9b", 2), ("deepseek-moe-16b", 0),
        ("deepseek-moe-16b", 2), ("mamba2-1.3b", 0), ("zamba2-2.7b", 0)]
ARCHS = ["gemma2-9b", "mamba2-1.3b", "zamba2-2.7b"]


@functools.lru_cache(maxsize=None)
def _model(arch):
    """SMOKE configs of both packages and their params (N(0, 1/d)
    embedding rows, so greedy streams vary)."""
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = J.init_params(jax.random.PRNGKey(0), jcfg)
    jp["embed"]["table"] = jp["embed"]["table"] * jcfg.d_model ** -0.5
    pp = P.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, pp


def _engine_kw(cfg, spec_k=0):
    if P.supports_paged(cfg):
        return dict(PAGED, spec_k=spec_k)
    return dict(DENSE)


def _requests(mod, vocab, paged):
    """Paged: four prompts, two sharing a 20-token prefix, one longer than
    the token budget several times over.  Dense: two equal-length prompts
    (one batched prefill) and two others."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 20)
    lens = (20, 37, 9, 25) if paged else (11, 11, 5, 17)
    out = []
    for i, L in enumerate(lens):
        p = rng.integers(0, vocab, L).astype(np.int32)
        if paged and i in (1, 3):
            p = np.concatenate([shared, p]).astype(np.int32)
        out.append(mod.Request(request_id=f"r{i}", session_key=f"r{i}",
                               prompt=p, max_new_tokens=8))
    return out


def _serve(eng):
    done = []
    eng.on_complete = done.append
    mod = psched if isinstance(eng, ServeEngine) else jsched
    for r in _requests(mod, eng.cfg.vocab_size, eng.paged):
        eng.submit(r)
    eng.run_until_drained()
    return {r.request_id: list(r.tokens) for r in done}


def _kernel_ticks(eng) -> int:
    """Ticks that ran the captured kind of tick."""
    return eng.stats.ticks if eng.paged else eng.stats.decode_ticks


# ================================================= static tick operands
def _storage(tree) -> tuple:
    """The data pointers of every tensor in ``tree`` (dicts, lists, tuples;
    other leaves ignored), in order."""
    if isinstance(tree, torch.Tensor):
        return (tree.data_ptr(),)
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return tuple(p for t in tree for p in _storage(t))
    return ()


@pytest.mark.parametrize("arch,spec_k", RUNS)
def test_tick_operands_never_move_and_streams_match_jax(arch, spec_k,
                                                        monkeypatch):
    """Every operand a tick hands its model step and its sampler (inputs,
    pool or caches, ``_last_tokens``; the logits excepted, an intermediate
    of the step) and its output buffer keep their storage over a whole
    served run, and the greedy streams still equal the JAX engine's."""
    jcfg, cfg, jp, pp = _model(arch)
    seen: dict[str, set] = {}

    def spy(name, fn, skip_first=False):
        def wrapped(*a, **k):
            seen.setdefault(name, set()).add(
                _storage(a[1:] if skip_first else a))
            return fn(*a, **k)
        monkeypatch.setattr(engine_mod, name, wrapped)

    spy("paged_mixed_step", engine_mod.paged_mixed_step)
    spy("speculative_verify", engine_mod.speculative_verify, skip_first=True)
    spy("decode_step", engine_mod.decode_step)
    kw = _engine_kw(cfg, spec_k)
    eng = ServeEngine(cfg, pp, device="cpu", **kw)
    tick = eng.tick
    outs = set()

    def tick_and_record():
        n = tick()
        outs.add(_storage([eng._out, getattr(eng, "_last_tokens", None)]))
        return n

    eng.tick = tick_and_record
    got = _serve(eng)
    want = _serve(JEngine(jcfg, jp, **kw))
    assert got == want
    names = (("paged_mixed_step", "speculative_verify") if eng.paged
             else ("decode_step",))
    assert sorted(seen) == sorted(names)
    for name in names:
        assert len(seen[name]) == 1, name
    assert len(outs) == 1
    assert not eng.cuda_graphs and eng.stats.graph_captures == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_graphs_on_the_cpu_raises(arch):
    jcfg, cfg, jp, pp = _model(arch)
    with pytest.raises(ValueError, match="cuda_graphs=True"):
        ServeEngine(cfg, pp, device="cpu", cuda_graphs=True,
                    **_engine_kw(cfg))
    assert not ServeEngine(cfg, pp, device="cpu",
                           **_engine_kw(cfg)).cuda_graphs


# ========================================================= workspaces
def test_workspace_held_by_a_capture_stays_alive_and_unshared(monkeypatch):
    """A buffer handed out inside ``kernels.holding()`` is listed once
    however often it was handed out; when a later call grows the buffer,
    the old one lives on in the list (so the allocator cannot give it to
    anything else), no later call hands it out again, and it dies with the
    list."""
    monkeypatch.setattr(kernels, "_workspaces", {})
    cpu = torch.device("cpu")
    with kernels.holding() as held:
        a = kernels.workspace(cpu, 100)
        assert kernels.workspace(cpu, 60) is a
        plan = kernels.workspace(cpu, 10, torch.int32)
    assert len(held) == 2 and held[0] is a and held[1] is plan
    ref = weakref.ref(a)
    ptr = a.data_ptr()
    del a
    b = kernels.workspace(cpu, 1000)             # grows: the dict drops a
    assert ref() is not None and ref().data_ptr() == ptr
    assert b.data_ptr() != ptr
    assert kernels.workspace(cpu, 10) is b
    assert all(kernels.workspace(cpu, n).data_ptr() != ptr
               for n in (1, 100, 1000))
    with kernels.holding() as other:
        kernels.workspace(cpu, 5)
    assert len(other) == 1 and other[0] is b and len(held) == 2
    del held
    assert ref() is None


# ==================================================== emulated capture
class _FakeStream:
    device = torch.device("cpu")

    def wait_stream(self, other):
        pass


class _FakeGraph:
    """``torch.cuda.CUDAGraph``'s semantics on the CPU: see the module
    docstring.  ``state`` lists the tensors a captured step may write."""
    state: list = []
    capturing = None

    def __init__(self):
        self.steps, self.generators = [], []

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def capture_begin(self):
        self.saved = [(t, t.clone()) for t in _FakeGraph.state]
        self.rng = [(g, g.get_state()) for g in self.generators]
        _FakeGraph.capturing = self

    def capture_end(self):
        _FakeGraph.capturing = None
        for t, before in self.saved:
            t.copy_(before)
        for g, st in self.rng:
            g.set_state(st)
        del self.saved, self.rng

    def replay(self):
        counts = kernels.launch_counts()
        for step in self.steps:
            step()
        now = kernels.launch_counts()
        kernels.add_launches({k: counts[k] - now[k] for k in now})


@pytest.fixture
def fake_cuda(monkeypatch):
    """Stand-ins for the CUDA calls of the engine's capture path, steps
    that register themselves with the graph being captured, and kernel
    wrappers that count their (plain) calls as launches."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(engine_mod, "_side_streams", {})
    for name in ("_mixed_step", "_dense_step"):
        orig = getattr(ServeEngine, name)

        def step(self, orig=orig):
            if _FakeGraph.capturing is not None:
                _FakeGraph.capturing.steps.append(lambda: orig(self))
            orig(self)

        monkeypatch.setattr(ServeEngine, name, step)
    for mod, name in ((da_ops, "ragged_paged_attention"),
                      (da_ops, "decode_attention"),
                      (fa_ops, "flash_attention"), (ssd_ops, "ssd")):
        monkeypatch.setattr(mod, name, _counting(getattr(mod, name)))
    yield
    _FakeGraph.state = []


def _counting(fn):
    def counted(*a, **k):
        counted.launches += 1
        return fn(*a, **k)

    counted.launches = 0
    return counted


def _captured(eng) -> ServeEngine:
    """``eng`` (built eager on the CPU) with its tick runner in capture
    mode, over the stand-in graph."""
    eng._tick_runner = engine_mod._GraphTick(
        eng.device, eng.stats, capture=True,
        generator=eng._gen if eng.temperature > 0 else None)
    store = eng.cm.pools if eng.paged else eng.cm.caches
    _FakeGraph.state = [t for layer in store if layer for t in layer.values()]
    _FakeGraph.state += [eng._out] + ([] if eng.paged else [eng._last_tokens])
    return eng


@pytest.mark.parametrize("arch,spec_k", RUNS)
def test_captured_ticks_replay_with_the_eager_streams(arch, spec_k,
                                                      fake_cuda):
    """Through the capture path: the first tick of the kind runs eagerly,
    the second is captured and replayed, every later one replays; the
    streams equal the eager engine's and the JAX engine's, and each
    kernel wrapper's count equals what the ticks launched (K1 at every
    layer of every paged tick, K4 at every shared attention of every dense
    decode tick, K3 and K2 in the eager prefills)."""
    jcfg, cfg, jp, pp = _model(arch)
    kw = _engine_kw(cfg, spec_k)
    eager = _serve(ServeEngine(cfg, pp, device="cpu", **kw))
    want = _serve(JEngine(jcfg, jp, **kw))
    for fn in kernels._counted().values():
        fn.launches = 0
    eng = _captured(ServeEngine(cfg, pp, device="cpu", **kw))
    got = _serve(eng)
    assert got == eager == want
    s = eng.stats
    n = _kernel_ticks(eng)
    assert n >= 3
    assert s.graph_captures == 1 and s.graph_replays == n - 1
    assert s.graph_capture_s > 0
    assert len(eng._tick_runner.graph.steps) == 1
    kinds = [spec.kind for spec in layer_specs(cfg)]
    launches = kernels.launch_counts()
    if eng.paged:
        assert s.host_syncs == s.ticks
        assert launches["ragged_paged_attention"] == s.ticks * cfg.n_layers
    else:
        assert s.host_syncs == s.decode_ticks + s.prefill_batches
        n_attn = kinds.count("shared_attn")
        assert launches["decode_attention"] == n_attn * s.decode_ticks
        assert launches["ssd"] == kinds.count("mamba") * s.prefill_batches
        assert launches["flash_attention"] == n_attn * s.prefill_batches


def test_replay_adds_the_captured_launch_counts(fake_cuda):
    """``_GraphTick`` alone: the capture's counts are taken back (the
    capture launched nothing), and every replay adds them."""
    stats = EngineStats()
    runner = engine_mod._GraphTick(torch.device("cpu"), stats, capture=True,
                                   generator=None)
    rpa, ssd = da_ops.ragged_paged_attention, ssd_ops.ssd
    rpa.launches = ssd.launches = 0
    calls = []

    def step():
        calls.append(1)
        rpa.launches += 3
        ssd.launches += 1

    for tick in range(1, 6):
        runner(step)
        assert (rpa.launches, ssd.launches) == (3 * tick, tick)
    assert len(calls) == 2            # eager, capture: a replay runs no Python
    assert stats.graph_captures == 1 and stats.graph_replays == 4
    assert runner._launches["ragged_paged_attention"] == 3


# ============================================================ sampling
def test_reseeded_generator_draws_what_a_fresh_seed_draws():
    """The engine's one generator, reseeded per dispatch, gives the draws a
    fresh generator from the same seed gives, in both samplers."""
    g = torch.Generator()
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(size=(4, 3, 50)).astype(np.float32))
    drafts = torch.from_numpy(rng.integers(0, 50, (4, 2)).astype(np.int32))
    dlen = torch.tensor([0, 1, 2, 2], dtype=torch.int32)
    for seed in (11, 12, 11, 999):
        a = sample_with_scores(logits[:, 0], seed, 0.7)
        b = sample_with_scores(logits[:, 0], g.manual_seed(seed), 0.7)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        a = speculative_verify(logits, drafts, dlen, seed, 1.0)
        b = speculative_verify(logits, drafts, dlen, g.manual_seed(seed), 1.0)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("arch", ARCHS)
def test_sampled_captured_ticks_draw_as_the_eager_ones(arch, fake_cuda):
    """Sampled ticks take the captured path too: the generator is
    registered with the graph and reseeded before every replay, so the
    streams equal the eager engine's."""
    jcfg, cfg, jp, pp = _model(arch)
    kw = dict(_engine_kw(cfg, 2 if P.supports_paged(cfg) else 0),
              temperature=1.0)
    eager = _serve(ServeEngine(cfg, pp, device="cpu", **kw))
    eng = _captured(ServeEngine(cfg, pp, device="cpu", **kw))
    assert _serve(eng) == eager
    assert eng._tick_runner.graph.generators == [eng._gen]
    assert eng.stats.graph_replays == _kernel_ticks(eng) - 1
