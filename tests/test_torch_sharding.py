"""Port parity: tensor-parallel paged serving over mesh slices, and
training placement, on the CPU.

The port's twins of the JAX package's ``tests/test_serving_sharding.py``
mesh tests (which skip in a one-device run) on logical CPU devices
(``launch.mesh.logical_devices``): a model-2 and a model-4 slice of
``ServeEngine`` give the JAX single-device engine's fp32 greedy streams on
the same params (model 4 shards the test config's 4 q heads while its 2
kv heads, and so the pool, stay replicated: each shard reads its kv head
of the pool in place); the first tick's logits stay within 2e-5 of the
unsharded port engine's; one host pull a tick; every pool publish is a
donate hit.  A session spilled off an int8 model-2 slice resumes on a
one-device slice bit for bit; a ``ServeCluster`` carves disjoint slices
and gives them back; ``elastic_reshard`` and ``ShardedBatcher`` place
training state and batches without changing a bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.models as J
from repro.serving.engine import ServeEngine as JEngine
from repro.serving.scheduler import Request as JRequest
import repro_torch.models as P
import repro_torch.serving.engine as engine_mod
from repro_torch.analysis.sanitizer import LockOrderTracker, SyncSiteSanitizer
from repro_torch.configs.registry import get_config
from repro_torch.core.devstore import DeviceStore
from repro_torch.core.pools import PoolSpec
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import (logical_devices, make_host_mesh,
                                     mesh_slices)
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.scheduler import Request
from repro_torch.training.data import DataConfig, ShardedBatcher
from repro_torch.training.ft import elastic_reshard
from repro_torch.tree import named_leaves, tree_leaves

torch.set_num_threads(1)

_CFG = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=128, dtype="float32",
            q_chunk=16)                   # tests/test_serving_sharding.py:14
CFG = P.ModelConfig(**_CFG)
PROMPT = np.arange(1, 9, dtype=np.int32)


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


def _jax_params(cfg):
    jcfg = J.ModelConfig(**dataclasses.asdict(cfg))
    jp = J.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, P.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                         device="cpu")


@pytest.fixture(scope="module")
def params():
    return _jax_params(CFG)


def _jax_stream(jcfg, jp, prompt=PROMPT, max_new=8, **kw):
    eng = JEngine(jcfg, jp, n_slots=2, max_len=32, **kw)
    req = JRequest(request_id="ref", session_key="s-ref", prompt=prompt,
                   max_new_tokens=max_new)
    eng.submit(req)
    eng.run_until_drained()
    return [int(t) for t in req.tokens]


def _stream(eng, prompt=PROMPT, rid="r", max_new=8):
    req = Request(request_id=rid, session_key=f"s-{rid}", prompt=prompt,
                  max_new_tokens=max_new)
    eng.submit(req)
    eng.run_until_drained()
    return req, [int(t) for t in req.tokens]


def _first_logits(monkeypatch, make, prompt=PROMPT, max_new=8):
    """Build an engine with ``make()``, serve ``prompt``, and return (the
    engine, its stream, the first tick's logits)."""
    seen = []
    inner = engine_mod.paged_mixed_step

    def spy(*a, **kw):
        out = inner(*a, **kw)
        if not seen:
            seen.append(out.clone())
        return out

    monkeypatch.setattr(engine_mod, "paged_mixed_step", spy)
    eng = make()
    _, got = _stream(eng, prompt, max_new=max_new)
    monkeypatch.setattr(engine_mod, "paged_mixed_step", inner)
    return eng, got, seen[0]


def _check_sharded_engine(eng, m):
    s = eng.stats
    assert s.host_syncs == s.ticks
    assert eng.cm.devstore.donate_misses == 0
    assert eng.cm.devstore.donate_hits >= s.ticks
    # the pool lives over the slice as ShardedTensors of m shards
    for leaf, pl in zip(tree_leaves(eng.cm.pools),
                        tree_leaves(eng.cm.pool_shardings)):
        assert isinstance(leaf, S.ShardedTensor)
        assert leaf.placement == pl and len(leaf.shards) == m
    # at least one param leaf really is split over the slice
    assert any(isinstance(p, S.ShardedTensor) and p.placement.splits(p.ndim)
               and len(p.shards) == m for p in tree_leaves(eng.params))


@pytest.mark.parametrize("model", [2, 4])
def test_sharded_engine_matches_the_jax_engine(params, monkeypatch, model):
    jcfg, jp, pp = params
    expected = _jax_stream(jcfg, jp)
    _, base, base_logits = _first_logits(
        monkeypatch, lambda: ServeEngine(CFG, pp, n_slots=2, max_len=32,
                                         device="cpu"))
    assert base == expected
    with logical_devices(8):
        [mesh] = mesh_slices(1, model)
    eng, got, logits = _first_logits(
        monkeypatch, lambda: ServeEngine(CFG, pp, n_slots=2, max_len=32,
                                         device="cpu", mesh=mesh))
    assert got == expected and len(got) == 8
    assert logits.shape == base_logits.shape
    assert float((logits - base_logits).abs().max()) <= 2e-5
    _check_sharded_engine(eng, model)
    tp = eng._tp
    assert tp.heads and tp.vocab is not None
    if model == 4:
        # 4 q heads split, 2 kv heads replicated: each shard's one q head
        # reads its kv head of the whole pool in place
        assert tp.kv_heads == ((0, 1), (0, 1), (1, 2), (1, 2))
        k = eng.cm.pools[0]["k"]
        assert all(t.shape == k.shape for t in k.shards)
        assert all(torch.equal(t, k.shards[0]) for t in k.shards)
    else:
        assert tp.kv_heads == (None, None)
        assert eng.cm.pools[0]["k"].shards[0].shape[2] == CFG.n_kv_heads // 2


def test_sharded_moe_engine_matches_the_jax_engine(monkeypatch):
    """deepseek-moe-16b SMOKE at model 2: the dense first layer's ffn and
    the routed and shared experts split on ffn, summed after the combine."""
    cfg = get_config("deepseek-moe-16b", smoke=True)
    jcfg, jp, pp = _jax_params(cfg)
    prompt = np.arange(3, 23, dtype=np.int32)
    expected = _jax_stream(jcfg, jp, prompt, max_new=6)
    _, base, base_logits = _first_logits(
        monkeypatch, lambda: ServeEngine(cfg, pp, n_slots=2, max_len=32,
                                         device="cpu"), prompt, 6)
    assert base == expected
    with logical_devices(2):
        [mesh] = mesh_slices(1, 2)
    eng, got, logits = _first_logits(
        monkeypatch, lambda: ServeEngine(cfg, pp, n_slots=2, max_len=32,
                                         device="cpu", mesh=mesh), prompt, 6)
    assert got == expected
    assert float((logits - base_logits).abs().max()) <= 2e-5
    _check_sharded_engine(eng, 2)
    moe = eng.params["layers"][1]["moe"]
    for name in ("w_gate", "w_up", "w_down"):
        assert moe[name].spec[0] == "data"            # experts: size 1
        assert moe[name].shards[0].shape[1 if name == "w_down" else 2] == \
            cfg.moe_d_ff // 2
    assert moe["shared"]["w_down"].spec == ("model", None)
    assert moe["router"].spec == (None, None)


def test_sharded_spill_adopt_round_trips_across_slices(params):
    """Spill a live session off an int8 model-2 slice, adopt it on a
    one-device slice: every leaf (int8 K/V and their f32 scales) comes back
    bit for bit, and the stream goes on as the uninterrupted JAX one."""
    jcfg, jp, pp = params
    expected = _jax_stream(jcfg, jp, kv_dtype="int8")
    with logical_devices(8):
        mesh_a, mesh_b = mesh_slices(2, 2)
        mesh_b = mesh_slices(1, 1, devices=list(mesh_b.devices.flat))[0]
    eng_a = ServeEngine(CFG, pp, n_slots=2, max_len=32, mesh=mesh_a,
                        kv_dtype="int8", device="cpu")
    eng_b = ServeEngine(CFG, pp, n_slots=2, max_len=32, mesh=mesh_b,
                        kv_dtype="int8", device="cpu")
    req = Request(request_id="mig", session_key="s-mig", prompt=PROMPT,
                  max_new_tokens=8)
    eng_a.submit(req)
    while len(req.tokens) < 3:
        eng_a.tick()
    slot_a = req.slot
    spilled = eng_a.spill(slot_a)
    assert spilled is not None and spilled.n_blocks > 0
    # global blocks, gathered over the kv heads: k, v, k_scale, v_scale
    assert len(tree_leaves(spilled.blocks)) == 4 * CFG.n_layers
    assert spilled.blocks[0]["k"].shape[2] == CFG.n_kv_heads
    eng_a.live.pop(slot_a)
    eng_a.cm.release(slot_a)
    assert eng_b.adopt(req, spilled)
    back = eng_b.spill(req.slot)
    for a, b in zip(tree_leaves(spilled.blocks), tree_leaves(back.blocks)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    eng_b.run_until_drained()
    assert [int(t) for t in req.tokens] == expected
    for e in (eng_a, eng_b):
        assert e.stats.host_syncs == e.stats.ticks + e.stats.spill_syncs
        assert e.cm.devstore.donate_misses == 0


def test_deployment_carves_disjoint_slices(params):
    """devices_per_replica=2 x 2 replicas on 8 logical devices: each engine
    owns its own slice, every request is answered, and stop() returns the
    4 devices to the node's free list (twin of the reference's
    ``test_deployment_carves_disjoint_slices``)."""
    from repro_torch.serving.cluster import ServeCluster

    _, _, pp = params
    with logical_devices(8):
        cluster = ServeCluster(CFG, pp, n_replicas=2, n_slots=2, max_len=32,
                               devices_per_replica=2, device="cpu")
    with cluster:
        sets = [set(e.mesh.devices.flat) for e in cluster.engines]
        assert all(len(s) == 2 for s in sets)
        assert sets[0].isdisjoint(sets[1])
        for e in cluster.engines:
            leaf = tree_leaves(e.cm.pools)[0]
            assert set(leaf.mesh.devices.flat) == set(e.mesh.devices.flat)
        rng = np.random.default_rng(0)
        for i in range(4):
            cluster.submit(f"sess-{i}", f"r{i}",
                           rng.integers(0, 128, (5,)).astype(np.int32),
                           max_new_tokens=4)
        cluster.run_until_drained(timeout_s=60.0)
        for i in range(4):
            out = cluster.result(f"r{i}")
            assert out is not None and len(out) == 4
        for e in cluster.engines:
            assert e.stats.host_syncs == e.stats.ticks
        assert cluster.kv_store.donate_misses == 0
        node = cluster.node
        free_before_stop = len(node._free_devices)
        assert free_before_stop == 4
        cluster.dep.stop()
        assert len(node._free_devices) == free_before_stop + 4
        with pytest.raises(ValueError, match="available"):
            node.take_device_slices(3, 3)


def test_dense_engine_rejects_a_mesh():
    cfg = get_config("mamba2-1.3b", smoke=True)
    pp = P.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with logical_devices(2):
        [mesh] = mesh_slices(1, 2)
    with pytest.raises(ValueError, match="paged block pool"):
        ServeEngine(cfg, pp, device="cpu", mesh=mesh)


def test_devstore_donates_only_exact_placements():
    """A sharded pool registered by its placement tree is stored by
    reference (its shards' data_ptrs kept); a tensor or another placement
    is copied onto the registered one (a miss)."""
    with logical_devices(4):
        mesh = make_host_mesh(4, model=2)
    store = DeviceStore("cpu", keep_versions=1)
    store.create_pool(PoolSpec(path="/kv"))
    pl = S.Placement(mesh, (None, "model"))
    x = torch.arange(32, dtype=torch.float32).view(4, 8)
    tree = [{"k": S.place(x, mesh, pl.spec)}]
    store.register_sharding("/kv/a", [{"k": pl}])
    ptrs = [t.data_ptr() for t in tree[0]["k"].shards]
    got = store.put("/kv/a", tree, donate=True)
    assert store.donate_hits == 1 and store.donate_misses == 0
    assert got[0]["k"] is tree[0]["k"]
    assert [t.data_ptr() for t in store.get("/kv/a")[0]["k"].shards] == ptrs
    other = [{"k": S.place(x, mesh, ("model", None))}]
    copied = store.put("/kv/a", other, donate=True)
    assert store.donate_misses == 1
    assert copied[0]["k"].placement == pl
    assert torch.equal(copied[0]["k"].gather("cpu"), x)
    store.put("/kv/a", [{"k": x}], donate=True)
    assert store.donate_misses == 2
    snap = store.snapshot("/kv")
    assert np.array_equal(snap["/kv/a"][0]["k"], x.numpy())


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_k1_reads_a_kv_head_slice_in_place(kv_dtype):
    """K1's wrapper takes a kv-head slice of a wider contiguous pool
    (``pool_kv_stride``) and gives what the copied slice gives."""
    from repro_torch.kernels.decode_attention import quant

    g = torch.Generator().manual_seed(0)
    N, bs, K, D = 6, 4, 4, 16
    pool_k = torch.randn((N, bs, K, D), generator=g)
    pool_v = torch.randn((N, bs, K, D), generator=g)
    kw = {}
    if kv_dtype == "int8":
        pool_k, ks = quant.quantize_kv(pool_k, "int8")
        pool_v, vs = quant.quantize_kv(pool_v, "int8")
        kw = dict(k_scale=ks, v_scale=vs)
    q = torch.randn((5, 2, D), generator=g)
    bt = torch.tensor([[1, 2, 3], [4, 5, -1]], dtype=torch.int32)
    rows = torch.tensor([0, 0, 1, 1, -1], dtype=torch.int32)
    pos = torch.tensor([9, 10, 3, 4, -1], dtype=torch.int32)
    cut = lambda t: t[:, :, 2:3]
    view_kw = {k: cut(v) for k, v in kw.items()}
    assert da_ops.pool_kv_stride(cut(pool_k)) == K
    assert da_ops.pool_kv_stride(pool_k) == K
    assert da_ops.pool_kv_stride(pool_k.transpose(0, 1)) == 0
    out = da_ops.ragged_paged_attention(q, cut(pool_k), cut(pool_v), bt,
                                        rows, pos, **view_kw)
    want = da_ops.ragged_paged_attention(
        q, cut(pool_k).contiguous(), cut(pool_v).contiguous(), bt, rows,
        pos, **{k: v.contiguous() for k, v in view_kw.items()})
    assert torch.equal(out, want)


@pytest.mark.parametrize("sliced", ["pool", "scales"])
def test_k1_refuses_scales_off_the_pools_kv_head_stride(sliced):
    """K1 reads scale (block, slot, kh) with the pools' kv-head stride, so
    its wrapper refuses scales laid out with another: a kv-head slice of
    the pools with contiguous scales, or contiguous pools with a kv-head
    slice of wider scales.  The slice of both passes."""
    from repro_torch.kernels.decode_attention import quant

    g = torch.Generator().manual_seed(0)
    N, bs, K, D = 6, 4, 4, 16
    pool_k, ks = quant.quantize_kv(torch.randn((N, bs, K, D), generator=g),
                                   "int8")
    pool_v, vs = quant.quantize_kv(torch.randn((N, bs, K, D), generator=g),
                                   "int8")
    q = torch.randn((5, 2, D), generator=g)
    bt = torch.tensor([[1, 2, 3], [4, 5, -1]], dtype=torch.int32)
    rows = torch.tensor([0, 0, 1, 1, -1], dtype=torch.int32)
    pos = torch.tensor([9, 10, 3, 4, -1], dtype=torch.int32)
    cut = lambda t: t[:, :, 2:3]
    tail = (None, None)                              # window, softcap
    da_ops._check(q, cut(pool_k), cut(pool_v), bt, rows, pos, cut(ks),
                  cut(vs), *tail)
    if sliced == "pool":
        pools = (cut(pool_k), cut(pool_v))
        scales = (cut(ks).contiguous(), cut(vs).contiguous())
    else:
        pools = (cut(pool_k).contiguous(), cut(pool_v).contiguous())
        scales = (cut(ks), cut(vs))
    with pytest.raises(ValueError, match="kv-head stride"):
        da_ops._check(q, *pools, bt, rows, pos, *scales, *tail)


def test_unsharded_engine_runs_a_one_shard_slice(params):
    """An engine given no mesh runs the same tick over a one-device slice:
    one local tree holding the given tensors, one local pool that is the
    pool, nothing split."""
    _, _, pp = params
    eng = ServeEngine(CFG, pp, n_slots=2, max_len=32, device="cpu")
    tp = eng._tp
    assert tp.devices == (torch.device("cpu"),) and tp.kv_heads == (None,)
    assert not (tp.heads or tp.ffn or tp.vocab)
    assert eng.params is pp and eng.cm.shard_pools == [eng.cm.pools]
    assert [t.data_ptr() for t in tree_leaves(eng._local_params[0])] == \
        [t.data_ptr() for t in tree_leaves(pp)]
    assert all(isinstance(t, torch.Tensor) for t in tree_leaves(eng.cm.pools))


def test_elastic_reshard_round_trips_bit_for_bit():
    """A param tree (1, 1) → (1, 2) → (2, 2) → (1, 1) by the logical-axis
    rules (fsdp on, so the (2, 2) mesh splits the embed dims too): every
    leaf comes back with the same bits (twin of the reference's elastic
    test)."""
    cfg = get_config("gemma2-9b", smoke=True)
    pp = P.init_params(cfg.replace(dtype="bfloat16"),
                       torch.Generator().manual_seed(0), device="cpu")
    axes = P.param_axes(cfg)
    with logical_devices(4):
        meshes = [make_host_mesh(1, 1), make_host_mesh(2, 2),
                  make_host_mesh(4, 2)]
    tree = pp
    for mesh in meshes + [meshes[0]]:
        placements = S.tree_shardings(axes, mesh,
                                      S.make_rules(cfg, mesh, fsdp=True))
        specs = {name: pl.spec for (name, _), pl in
                 zip(named_leaves(tree), tree_leaves(placements))}
        tree = elastic_reshard(tree, mesh, lambda path, leaf: specs[path])
        assert all(isinstance(t, S.ShardedTensor) and t.mesh == mesh
                   for t in tree_leaves(tree))
        splits = any(t.placement.splits(t.ndim) for t in tree_leaves(tree))
        assert splits == (mesh.size > 1)
    for got, want in zip(tree_leaves(tree), tree_leaves(pp)):
        back = got.gather("cpu")
        assert back.dtype == want.dtype
        assert torch.equal(back.view(torch.uint8), want.view(torch.uint8))


def test_sharded_batcher_places_batch_leaves():
    cfg = get_config("gemma2-9b", smoke=True)
    dcfg = DataConfig(batch=4, seq_len=8, seed=3)
    with logical_devices(4):
        mesh = make_host_mesh(4, model=2)
    rules = S.make_rules(cfg, mesh, batch=dcfg.batch)
    plain = next(ShardedBatcher(cfg, dcfg, device="cpu"))
    placements = S.batch_shardings(plain, mesh, rules)
    assert all(pl.spec == (("data",), None) for pl in placements.values())
    placed = next(ShardedBatcher(cfg, dcfg, placements, device="cpu"))
    single = next(ShardedBatcher(cfg, dcfg, placements["inputs"],
                                 device="cpu"))
    for k, v in plain.items():
        for got in (placed[k], single[k]):
            assert isinstance(got, S.ShardedTensor)
            assert got.shards[0].shape == (2, 8)        # batch over data=2
            assert torch.equal(got.gather("cpu"), v)
