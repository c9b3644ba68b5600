"""Port parity: host-side serving state and the paged ``ServeEngine`` of the
PyTorch port against the JAX package, on the CPU.

The same sequence of operations is replayed on both packages' allocator,
cache manager and scheduler, and their states must end equal.  Both engines
then serve the same prompts with the same params (a JAX ``init_params`` tree
carried across through numpy): greedy streams must be equal at fp32, and so
must every tick counter.
"""
import jax
import numpy as np
import pytest
import torch

import repro.models as J
from repro.configs.registry import get_config as jget_config
from repro.core.pools import DispatchPolicy as JPolicy
from repro.serving import kvcache as jkv
from repro.serving import scheduler as jsched
from repro.serving.engine import ServeEngine as JEngine
import repro_torch.models as P
from repro_torch.configs.registry import get_config
from repro_torch.core.pools import DispatchPolicy
from repro_torch.serving import kvcache as pkv
from repro_torch.serving import scheduler as psched
from repro_torch.serving.engine import ServeEngine

torch.set_num_threads(1)

_CFG = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=128, dtype="float32",
            q_chunk=16)                          # tests/test_paged_kv.py:14
CONFIGS = {"test": (J.ModelConfig(**_CFG), P.ModelConfig(**_CFG)),
           "gemma2_smoke": (jget_config("gemma2-9b", smoke=True),
                            get_config("gemma2-9b", smoke=True))}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    """(name, JAX cfg, port cfg, JAX params, port params).  The embedding
    table is scaled to N(0, 1/d) so random-weight greedy streams vary
    instead of echoing the last prompt token."""
    jcfg, pcfg = CONFIGS[request.param]
    jp = J.init_params(jax.random.PRNGKey(0), jcfg)
    jp["embed"]["table"] = jp["embed"]["table"] * jcfg.d_model ** -0.5
    pp = P.params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, device="cpu")
    return request.param, jcfg, pcfg, jp, pp


# ============================================== allocator / manager replay
def _alloc_state(a):
    trie = sorted((path, sorted(m.block for m in metas))
                  for path, metas in a.trie.iter_prefixes())
    return (list(a.free), list(a.refcount), trie, a.evictions,
            a.dedup_blocks, a.available(), a.blocks_in_use)


def test_allocator_replay_ends_equal():
    def replay(mod):
        a = mod.PrefixBlockAllocator(num_blocks=7, block_size=2)
        log = []
        t1 = a.allocate(3)
        log.append((t1, a.cache_blocks([1, 2, 3, 4, 5, 6], t1)))
        a.unref(t1)
        m = a.match([1, 2, 3, 4, 9, 9], max_blocks=3)
        t2 = m + a.allocate(1)
        log.append((list(t2), a.cache_blocks([1, 2, 3, 4, 9, 9], t2)))
        t3 = a.allocate(2)                        # evicts LRU leaf
        dup = a.allocate(1)                       # a racing duplicate block
        log.append(a.cache_blocks_range([1, 2, 7, 7], dup + t3[:1], 0, 2, ""))
        log.append((t3, dup, a.allocate(9)))      # impossible: None
        a.unref(t2)
        a.unref(t3)
        log.append(a.path_key([1, 2, 3, 4], 2))
        return log, _alloc_state(a)

    assert replay(pkv) == replay(jkv)


def _manager_replay(mod, cfg, **kw):
    cm = mod.PagedCacheManager(cfg, n_slots=3, max_len=40, block_size=4,
                               num_blocks=16, **kw)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 100, 12)
    p0 = np.concatenate([shared, rng.integers(0, 100, 7)]).astype(np.int32)
    p1 = np.concatenate([shared, rng.integers(0, 100, 3)]).astype(np.int32)
    log = []
    s0 = cm.acquire("a")
    cm.begin(s0, p0, max_new_tokens=6)
    log.append(cm.commit_prefill_progress(s0, 8))    # chunk 1: 2 blocks
    s1 = cm.acquire("b")
    seq1 = cm.begin(s1, p1, max_new_tokens=4)        # same-tick sharing
    log.append((seq1.reused, list(seq1.table)))
    log.append(cm.commit_prefill_progress(s0, len(p0)))
    log.append(cm.commit_prefill_progress(s1, len(p1)))
    cm.ensure_decode_blocks()
    cm.ensure_decode_blocks({s0: 3}, only={s0})      # speculative rows
    cm.slots[s0].pos += 1
    log.append(cm.rollback_writes(s0, cm.slots[s0].pos))
    log.append(cm.available_for_admission())
    cm.finish(s0, [5, 6])
    s2 = cm.acquire("c")
    log.append(cm.begin(s2, p0, max_new_tokens=2).reused)   # warm prefix
    cm.release(s1)
    log.append(cm.block_tables().tolist())
    log.append([(s.request_id, s.pos, s.prefill_pos, s.committed, s.trie_key,
                 s.reserve, s.reused, list(s.table)) for s in cm.slots])
    log.append((cm.n_active, cm.blocks_in_use, cm.written_max(10, 4),
                cm.block_cost(10, 4), cm.max_blocks, cm.num_blocks))
    return log, _alloc_state(cm.alloc)


def test_cache_manager_replay_ends_equal():
    jcfg, pcfg = CONFIGS["test"]
    assert _manager_replay(pkv, pcfg, device="cpu") == \
        _manager_replay(jkv, jcfg)


def test_scheduler_replay_picks_the_same_requests():
    def replay(mod, policy):
        s = mod.Scheduler(policy=policy, n_replicas=3, prefill_budget=2)
        t0 = 1000.0
        reqs = []
        for i in range(9):
            r = mod.Request(request_id=f"r{i}", session_key=f"s{i % 4}",
                            prompt=np.arange(i + 1), max_new_tokens=4,
                            slo=("interactive" if i % 3 == 0 else "batch"),
                            deadline_s=(0.5 if i == 4 else None))
            r.arrived_s = t0 + i * 0.01
            reqs.append(r)
        homes = [s.submit(r) for r in reqs]
        out = [homes]
        cost = lambda r: len(r.prompt)
        for rep in range(3):
            best = s.best_waiting(rep)
            out.append(best.request_id if best else None)
            got = s.admit_one(rep, free_slots=2, free_blocks=4,
                              block_cost=cost, max_blocks=6)
            out.append(got.request_id if got else None)
            if got is not None:
                s.requeue(rep, got)
            out.append([r.request_id for r in s.admit(rep, free_slots=3)])
            out.append([r.request_id for r in s.pop_expired(rep, t0 + 1.0)])
            out.append([r.request_id for r in s.drain(rep)])
        out.append([mod.virtual_deadline(r) for r in reqs])
        return out

    assert replay(psched, DispatchPolicy.FIFO) == replay(jsched, JPolicy.FIFO)
    assert replay(psched, DispatchPolicy.ROUND_ROBIN) == \
        replay(jsched, JPolicy.ROUND_ROBIN)
    assert psched.SLO_TARGETS == jsched.SLO_TARGETS


# ============================================================== the engine
class JunkDrafts:
    """Always proposes k copies of one token: mostly rejected, so the
    rollback path runs (a duck-typed DraftSource for both packages)."""

    def propose(self, req, history, k):
        return [1] * k


def _requests(mod, vocab):
    """Four prompts: two share a 20-token prefix, one is longer than the
    token budget several times over (chunked prefill)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 20)
    out = []
    for i, L in enumerate((20, 37, 9, 25)):
        p = rng.integers(0, vocab, L).astype(np.int32)
        if i in (1, 3):
            p = np.concatenate([shared, p]).astype(np.int32)
        out.append(mod.Request(request_id=f"r{i}", session_key=f"r{i}",
                               prompt=p, max_new_tokens=10))
    return out


def _serve(engine):
    done = []
    engine.on_complete = done.append
    for r in _requests(psched if isinstance(engine, ServeEngine) else jsched,
                       engine.cfg.vocab_size):
        engine.submit(r)
    engine.run_until_drained()
    s = engine.stats
    counters = (s.ticks, s.prefill_chunks, s.prefix_hit_tokens, s.spec_drafted,
                s.spec_accepted, s.spec_rolled_back, s.host_syncs,
                s.decode_ticks, s.tokens_out, s.prompt_tokens,
                s.prefill_tokens, s.prefix_hits)
    return {r.request_id: list(r.tokens) for r in done}, counters, s


@pytest.mark.parametrize("spec_k,drafts", [(0, None), (2, None),
                                           (2, JunkDrafts)])
def test_engine_matches_jax_engine(model, spec_k, drafts):
    name, jcfg, pcfg, jp, pp = model
    kw = dict(n_slots=4, max_len=96, block_size=4, token_budget=8,
              spec_k=spec_k)
    jstreams, jcount, _ = _serve(JEngine(
        jcfg, jp, draft_source=drafts() if drafts else None, **kw))
    pstreams, pcount, stats = _serve(ServeEngine(
        pcfg, pp, draft_source=drafts() if drafts else None, device="cpu",
        **kw))
    assert pstreams == jstreams
    assert pcount == jcount
    assert stats.host_syncs == stats.ticks
    assert stats.prefix_hit_tokens > 0 and stats.prefill_chunks > 8
    if drafts is JunkDrafts:
        assert stats.spec_rolled_back > 0


def test_engine_sampled_streams_complete(model):
    """Sampling (temperature > 0) draws from torch's generator, so streams
    are not compared with JAX's; they complete with in-vocab tokens and the
    one-sync-per-tick invariant holds."""
    name, jcfg, pcfg, jp, pp = model
    eng = ServeEngine(pcfg, pp, n_slots=4, max_len=96, block_size=4,
                      token_budget=8, spec_k=2, temperature=1.0,
                      device="cpu")
    streams, _, stats = _serve(eng)
    assert all(len(t) == 10 for t in streams.values())
    assert all(0 <= t < pcfg.vocab_size for s in streams.values() for t in s)
    assert stats.host_syncs == stats.ticks


def test_engine_rejects_unservable_requests_through_completion(model):
    name, jcfg, pcfg, jp, pp = model
    eng = ServeEngine(pcfg, pp, n_slots=2, max_len=32, block_size=4,
                      num_blocks=6, device="cpu")
    done = []
    eng.on_complete = done.append
    eng.submit(psched.Request(request_id="long", session_key="a",
                              prompt=np.zeros(40, np.int32)))
    eng.submit(psched.Request(request_id="big", session_key="b",
                              prompt=np.zeros(20, np.int32),
                              max_new_tokens=8))
    assert [r.request_id for r in done] == ["long", "big"]
    assert "max_len" in done[0].error and "KV blocks" in done[1].error
    assert eng.idle()


def test_deferred_features_raise_not_implemented(model):
    name, jcfg, pcfg, jp, pp = model
    for kw in (dict(preempt=True), dict(spill_pool=object()),
               dict(devstore=object()), dict(kv_key="/kv/x"),
               dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="slice"):
            ServeEngine(pcfg, pp, device="cpu", **kw)
    eng = ServeEngine(pcfg, pp, n_slots=2, max_len=32, device="cpu")
    for call in (lambda: eng.spill(0), lambda: eng.evacuate(),
                 lambda: eng.adopt(None, None)):
        with pytest.raises(NotImplementedError, match="cluster"):
            call()


def test_deadlines_expire_at_the_same_stages_as_jax(model):
    """Deadline sweeps at admission, in the queue, mid-prefill and mid-decode
    resolve the same requests at the same stages, with the same partial
    streams, as the reference engine."""
    name, jcfg, pcfg, jp, pp = model

    def run(engine, mod):
        done = []
        engine.on_complete = done.append
        reqs = _requests(mod, engine.cfg.vocab_size)
        late = mod.Request(request_id="late", session_key="x",
                           prompt=np.arange(5, dtype=np.int32),
                           deadline_s=0.0)
        late.arrived_s -= 1.0
        engine.submit(late)                     # expired at admission
        for r in reqs:
            engine.submit(r)
        engine.tick()
        engine.tick()
        for r in reqs[1:]:                      # prefilling, decoding, queued
            r.deadline_s = 0.0
        engine.run_until_drained()
        return ([(r.request_id, list(r.tokens),
                  r.error["stage"] if isinstance(r.error, dict) else r.error)
                 for r in done], engine.stats.deadline_exceeded,
                engine.stats.ticks)

    kw = dict(n_slots=2, max_len=96, block_size=4, token_budget=8)
    want = run(JEngine(jcfg, jp, **kw), jsched)
    got = run(ServeEngine(pcfg, pp, device="cpu", **kw), psched)
    assert got == want
    assert got[1] == 4
