"""Port parity: preemption, spill and adoption on the port's paged engine,
against the JAX package's engine, on the CPU.

The scenarios of ``tests/test_preempt_resume.py`` (its config, 2 slots and
11 blocks): a greedy stream interrupted by a preemption, its KV parked in a
``SpillPool`` and restored by ``adopt`` or lost and replayed from the folded
prompt, must equal the JAX engine's uninterrupted stream at fp32, with the
allocator drained exactly.  Every pool leaf round-trips spill → host →
adopt bit for bit at every kv_dtype, in place (the pool tensors keep their
storage), and a session spilled by the JAX engine resumes on the port's.
"""
import time

import jax
import numpy as np
import pytest
import torch

import repro.models as J
from repro.serving import scheduler as jsched
from repro.serving.engine import ServeEngine as JEngine
import repro_torch.models as P
from repro_torch.core.pools import PoolSpec
from repro_torch.core.store import CascadeStore, SpillPool, Worker
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving import scheduler as psched
from repro_torch.serving.kvcache import SpilledKV
from repro_torch.serving.scheduler import (SLO_BATCH, SLO_INTERACTIVE,
                                           Request)

torch.set_num_threads(1)

_CFG = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=128, dtype="float32",
            q_chunk=16)                   # tests/test_preempt_resume.py:20
JCFG, PCFG = J.ModelConfig(**_CFG), P.ModelConfig(**_CFG)
MAX_NEW_BATCH = 8
MAX_NEW_INTER = 3


@pytest.fixture(scope="module")
def params():
    jp = J.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, P.params_from_numpy(jax.tree.map(np.asarray, jp), PCFG,
                                   device="cpu")


def _prompts(seed):
    rng = np.random.default_rng(seed)
    return {
        "b0": rng.integers(1, JCFG.vocab_size, (8,)).astype(np.int32),
        "b1": rng.integers(1, JCFG.vocab_size, (8,)).astype(np.int32),
        "i0": rng.integers(1, JCFG.vocab_size, (4,)).astype(np.int32),
    }


def _req(mod, rid, prompt, slo):
    max_new = MAX_NEW_INTER if slo == SLO_INTERACTIVE else MAX_NEW_BATCH
    return mod.Request(request_id=rid, session_key=f"sess-{rid}",
                       prompt=prompt, max_new_tokens=max_new, slo=slo)


_BASELINES: dict[int, dict] = {}


def _jax_baseline(jp, seed):
    """The JAX engine's uninterrupted greedy run with slack capacity (no
    pressure, no preemption): the reference streams."""
    if seed not in _BASELINES:
        prompts = _prompts(seed)
        eng = JEngine(JCFG, jp, n_slots=8, max_len=48, temperature=0.0,
                      block_size=4, num_blocks=64, prefix_cache=False)
        done = {}
        eng.on_complete = lambda r: done.setdefault(r.request_id, r)
        for rid in ("b0", "b1", "i0"):
            eng.submit(_req(jsched, rid, prompts[rid],
                            SLO_INTERACTIVE if rid == "i0" else SLO_BATCH))
        eng.run_until_drained()
        assert eng.stats.preemptions == 0
        _BASELINES[seed] = {rid: list(r.tokens) for rid, r in done.items()}
    return _BASELINES[seed]


def _ptrs(eng):
    return [t.data_ptr() for pool in eng.cm.pools for t in pool.values()]


def _preempt_run(pp, prompts, spill_pool):
    """The tight port engine (2 slots, 10 usable blocks): both batch
    requests fill it, then an interactive arrival forces a preemption
    mid-decode.  Every pool leaf keeps its storage throughout."""
    eng = ServeEngine(PCFG, pp, n_slots=2, max_len=48, temperature=0.0,
                      block_size=4, num_blocks=11, prefix_cache=False,
                      spill_pool=spill_pool, preempt=True, device="cpu")
    ptrs = _ptrs(eng)
    done = {}
    eng.on_complete = lambda r: done.setdefault(r.request_id, r)
    eng.submit(_req(psched, "b0", prompts["b0"], SLO_BATCH))
    eng.submit(_req(psched, "b1", prompts["b1"], SLO_BATCH))
    stop = time.monotonic() + 30
    while not (len(eng.live) == 2
               and all(r.tokens for r in eng.live.values())):
        eng.tick()
        assert time.monotonic() < stop, "batch requests never went live"
    eng.submit(_req(psched, "i0", prompts["i0"], SLO_INTERACTIVE))
    eng.run_until_drained()
    assert {r.error for r in done.values()} == {None}
    assert _ptrs(eng) == ptrs, "a pool leaf was rebound"
    return eng, {rid: list(r.tokens) for rid, r in done.items()}


def _assert_drained_exactly(eng):
    """tests/test_preempt_resume.py:_assert_drained_exactly."""
    alloc = eng.cm.alloc
    assert alloc.blocks_in_use == 0
    assert all(not s.active for s in eng.cm.slots)
    assert len(alloc.free) == len(set(alloc.free)) == eng.cm.num_blocks - 1
    assert eng.cm.available_for_admission() == alloc.available()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preempt_resume_via_spill_pool_matches_jax(params, seed):
    jp, pp = params
    ref = _jax_baseline(jp, seed)
    pool = SpillPool(capacity_blocks=64)
    eng, got = _preempt_run(pp, _prompts(seed), pool)
    assert got == ref
    s = eng.stats
    assert s.preemptions >= 1 and s.resumes >= 1 and s.spilled_blocks >= 1
    assert s.adopted_sessions == s.resumes
    assert s.spill_syncs == s.spilled_sessions >= 1
    assert s.host_syncs == s.ticks + s.spill_syncs
    _assert_drained_exactly(eng)
    assert pool.blocks == 0 and pool.evicted == 0
    assert pool.parked == pool.unparked >= 1
    assert set(s.queue_wait_s) == {SLO_BATCH, SLO_INTERACTIVE}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preempt_resume_via_replay_fallback_matches_jax(params, seed):
    """A capacity-0 pool refuses every park: the victim's emissions fold
    into its prompt and it replays; the spill still happened and counts."""
    jp, pp = params
    ref = _jax_baseline(jp, seed)
    pool = SpillPool(capacity_blocks=0)
    eng, got = _preempt_run(pp, _prompts(seed), pool)
    assert got == ref
    s = eng.stats
    assert s.preemptions >= 1 and s.resumes == 0 == s.adopted_sessions
    assert pool.parked == 0 and pool.blocks == 0
    assert s.spill_syncs >= 1
    assert s.host_syncs == s.ticks + s.spill_syncs
    _assert_drained_exactly(eng)


def test_preempt_without_pool_keeps_strict_sync_invariant(params):
    jp, pp = params
    ref = _jax_baseline(jp, 3)
    eng, got = _preempt_run(pp, _prompts(3), None)
    assert got == ref
    s = eng.stats
    assert s.preemptions >= 1
    assert s.spill_syncs == 0 and s.spilled_blocks == 0
    assert s.host_syncs == s.ticks
    _assert_drained_exactly(eng)


def test_preempt_through_store_backed_pool_matches_jax(params):
    """The pool as a deployment creates it: store-backed under
    /spill/<model>; every park is published, every unpark tombstoned."""
    jp, pp = params
    ref = _jax_baseline(jp, 0)
    store = CascadeStore([Worker(0, n_upcall_threads=1)])
    store.create_pool(PoolSpec(path="/spill/t", replication=1))
    try:
        pool = SpillPool(capacity_blocks=64, store=store, prefix="/spill/t")
        eng, got = _preempt_run(pp, _prompts(0), pool)
        assert got == ref
        assert eng.stats.resumes >= 1
        for rid in ("b0", "b1"):
            obj = store.get(f"/spill/t/{rid}")
            assert obj is None or obj.payload is None
        _assert_drained_exactly(eng)
    finally:
        store.close()


def test_preempt_requires_paged_path(params):
    _, pp = params
    with pytest.raises(ValueError, match="preemption"):
        ServeEngine(PCFG, pp, paged=False, preempt=True, device="cpu")


# ======================================================== spill round trip
def _random_pools(eng, seed):
    """Every pool leaf filled with random bits (NaN patterns included)."""
    g = torch.Generator().manual_seed(seed)
    for pool in eng.cm.pools:
        for t in pool.values():
            bits = torch.randint(0, 256, (t.numel() * t.element_size(),),
                                 dtype=torch.uint8, generator=g)
            t.view(-1).view(torch.uint8).copy_(bits)


def _leaf_bits(t):
    return t.contiguous().view(-1).view(torch.uint8)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8",
                                      "fp8_e4m3"])
def test_every_pool_leaf_round_trips_bit_for_bit(params, kv_dtype):
    """spill_device → one pull → adopt into fresh blocks: every leaf of
    every layer (K/V and, quantized, the scales) comes back bit for bit,
    written into the pool tensors in place."""
    _, pp = params
    eng = ServeEngine(PCFG, pp, n_slots=2, max_len=48, block_size=4,
                      num_blocks=16, prefix_cache=False, kv_dtype=kv_dtype,
                      device="cpu")
    _random_pools(eng, 7)
    ptrs = _ptrs(eng)
    req = Request(request_id="a", session_key="a",
                  prompt=np.arange(1, 15, dtype=np.int32), max_new_tokens=4)
    slot = eng.cm.acquire("a")
    seq = eng.cm.begin(slot, req.prompt, req.max_new_tokens)
    eng.cm.commit_prefill_progress(slot, len(req.prompt))
    table = list(seq.table)
    want = [{k: _leaf_bits(t[table]) for k, t in pool.items()}
            for pool in eng.cm.pools]
    syncs = eng.stats.host_syncs
    spilled = eng.spill(slot)
    assert eng.stats.host_syncs == syncs + 1 == eng.stats.spill_syncs
    assert isinstance(spilled, SpilledKV)
    assert (spilled.n_blocks, spilled.pos, spilled.block_size) == \
        (len(table), len(req.prompt), 4)
    assert spilled.nbytes == sum(t.numel() * t.element_size()
                                 for pool in eng.cm.pools
                                 for t in pool.values()) * len(table) // 16
    for layer, exp in zip(spilled.blocks, want):
        assert layer.keys() == exp.keys()
        for k in exp:
            assert layer[k].device.type == "cpu"
            assert torch.equal(_leaf_bits(layer[k]), exp[k]), k
    eng.cm.release(slot)
    _random_pools(eng, 8)                 # the old blocks are overwritten
    req.tokens = [3]
    assert eng.adopt(req, spilled)
    new = eng.cm.slots[req.slot]
    assert new.pos == spilled.pos and len(new.table) == len(table)
    for pool, exp in zip(eng.cm.pools, want):
        for k, t in pool.items():
            assert torch.equal(_leaf_bits(t[new.table]), exp[k]), k
    assert _ptrs(eng) == ptrs, "adopt rebound a pool leaf"
    assert eng.stats.adopted_sessions == 1


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8",
                                      "fp8_e4m3"])
def test_spilled_blocks_carry_across_packages(params, kv_dtype):
    """``spilled_to_numpy`` gives the JAX tree layout and
    ``spilled_from_numpy`` inverts it bit for bit."""
    _, pp = params
    eng = ServeEngine(PCFG, pp, n_slots=1, max_len=48, block_size=4,
                      num_blocks=8, prefix_cache=False, kv_dtype=kv_dtype,
                      device="cpu")
    _random_pools(eng, 3)
    slot = eng.cm.acquire("a")
    eng.cm.begin(slot, np.arange(1, 10, dtype=np.int32), 2)
    spilled = eng.spill(slot)
    tree = P.spilled_to_numpy(spilled.blocks, PCFG)
    jpools = J.init_paged_pools(JCFG, 8, 4, kv_dtype=kv_dtype)
    assert jax.tree.structure(tree) == jax.tree.structure(jpools)
    for leaf, jleaf in zip(jax.tree.leaves(tree), jax.tree.leaves(jpools)):
        assert leaf.shape == (jleaf.shape[0], spilled.n_blocks,
                              *jleaf.shape[2:])
        assert leaf.dtype.itemsize == jleaf.dtype.itemsize
    # raw bits read back as the JAX leaves' own dtypes (bfloat16, fp8)
    tree = jax.tree.map(lambda a, j: a.view(j.dtype), tree, jpools)
    back = P.spilled_from_numpy(tree, PCFG)
    for a, b in zip(back, spilled.blocks):
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert torch.equal(_leaf_bits(a[k]), _leaf_bits(b[k]))


def test_session_spilled_by_jax_resumes_on_the_port(params):
    """Cross-package migration: the JAX engine spills a live session; its
    blocks carry over through ``spilled_from_numpy``; the port's engine
    adopts it and finishes the stream, which equals the JAX engine's
    uninterrupted run."""
    jp, pp = params
    prompt = _prompts(4)["b0"]
    ref = JEngine(JCFG, jp, n_slots=2, max_len=48, block_size=4,
                  num_blocks=16, prefix_cache=False)
    want = {}
    ref.on_complete = lambda r: want.setdefault(r.request_id, list(r.tokens))
    ref.submit(_req(jsched, "m", prompt, SLO_BATCH))
    ref.run_until_drained()

    src = JEngine(JCFG, jp, n_slots=2, max_len=48, block_size=4,
                  num_blocks=16, prefix_cache=False)
    jreq = _req(jsched, "m", prompt, SLO_BATCH)
    src.submit(jreq)
    while len(jreq.tokens) < 3:
        src.tick()
    slot = jreq.slot
    jspilled = src.spill(slot)
    src.live.pop(slot)
    src.cm.release(slot)

    dst = ServeEngine(PCFG, pp, n_slots=2, max_len=48, block_size=4,
                      num_blocks=16, prefix_cache=False, device="cpu")
    done = {}
    dst.on_complete = lambda r: done.setdefault(r.request_id, r)
    preq = Request(request_id="m", session_key="sess-m", prompt=prompt,
                   max_new_tokens=MAX_NEW_BATCH)
    preq.tokens = list(jreq.tokens)
    spilled = SpilledKV(request_id=jspilled.request_id, pos=jspilled.pos,
                        n_blocks=jspilled.n_blocks,
                        block_size=jspilled.block_size,
                        blocks=P.spilled_from_numpy(jspilled.blocks, PCFG))
    assert spilled.nbytes == jspilled.nbytes
    assert dst.adopt(preq, spilled)
    dst.run_until_drained()
    assert done["m"].tokens == want["m"]
    assert dst.stats.host_syncs == dst.stats.ticks
    _assert_drained_exactly(dst)


# ============================================================ SpillPool unit
def test_spill_pool_park_unpark_discard_accounting():
    pool = SpillPool(capacity_blocks=8)
    assert pool.park("a", "kv-a", 3)
    assert pool.park("b", "kv-b", 4)
    assert pool.blocks == 7 and pool.has("a") and pool.has("b")
    assert pool.unpark("a") == "kv-a"
    assert pool.blocks == 4 and not pool.has("a")
    assert pool.unpark("a") is None
    pool.discard("b")
    assert pool.blocks == 0
    assert pool.stats() == {"spill_pool_blocks": 0, "spill_pool_parked": 2,
                            "spill_pool_unparked": 1, "spill_pool_evicted": 0}


def test_spill_pool_evicts_oldest_first_and_refuses_oversized():
    pool = SpillPool(capacity_blocks=8)
    assert not pool.park("huge", "kv", 9)
    assert pool.park("a", "kv-a", 4)
    assert pool.park("b", "kv-b", 4)
    assert pool.park("c", "kv-c", 4)
    assert not pool.has("a") and pool.has("b") and pool.has("c")
    assert pool.evicted == 1 and pool.blocks == 8
    assert pool.park("c", "kv-c2", 2)
    assert pool.blocks == 6 and pool.unpark("c") == "kv-c2"


def test_spill_pool_store_backed_publishes_and_tombstones():
    store = CascadeStore([Worker(0, n_upcall_threads=1)])
    store.create_pool(PoolSpec(path="/spill/m"))
    try:
        pool = SpillPool(capacity_blocks=8, store=store, prefix="/spill/m")
        pool.park("r1", {"kv": 1}, 2)
        obj = store.get("/spill/m/r1")
        assert obj is not None and obj.payload == {"kv": 1}
        assert pool.unpark("r1") == {"kv": 1}
        obj = store.get("/spill/m/r1")
        assert obj is not None and obj.payload is None
        assert pool.unpark("r1") is None
        pool.park("r2", {"kv": 2}, 2)
        sibling = SpillPool(capacity_blocks=8, store=store, prefix="/spill/m")
        assert sibling.unpark("r2") == {"kv": 2}
        assert sibling.unpark("r2") is None
    finally:
        store.close()
