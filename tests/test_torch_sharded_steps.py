"""Port parity: the sharded dense programs (``launch.spmd.Program``,
``make_train_step(mesh=)``) against the port's one-device programs and the
JAX package's unsharded functions, on the CPU.

Logical CPU devices (``launch.mesh.logical_devices``) make (data, model)
meshes of (1, 2), (2, 1), (2, 2) and (1, 4) (gemma2-9b SMOKE splits its q
heads over a replicated kv-head cache there), and (pod, data, model) meshes
of (2, 1, 2) and (2, 2, 2).  The same params (a JAX ``init_params`` tree
carried across through numpy) and inputs go through JAX's ``forward`` /
``prefill`` / ``decode_step``, the port's one-device functions and the
sharded ones: attention, MLP, MoE (model-split slices here; the experts
over 'data' in ``tests/test_torch_expert_parallel.py``), Mamba-2 split by
SSM heads and zamba2's shared block.
Tolerances: sharded against one-device at the suite's f32 2e-5
(``tests/test_kernels.py``), against JAX at the model tests' 1e-4
(``tests/test_torch_models.py``), each as rtol and as atol times the
output's largest magnitude (a sum's rounding in another order is relative
to its terms' scale, not to a small result's); train states at the
training suite's leaf tolerances (``tests/test_torch_train_steps.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as J
from repro.configs.registry import get_config as jget_config
from repro.training import optimizer as jopt
from repro.training import train as jtrain
import repro_torch.models as P
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import _make_mesh, logical_devices
from repro_torch.launch.spmd import Program
from repro_torch.serving.engine import ServeEngine
from repro_torch.training import (DataConfig, ShardedBatcher, clone_state,
                                  get_optimizer, init_train_state,
                                  make_train_step, train_state_from_numpy)
from repro_torch.tree import named_leaves, tree_leaves

torch.set_num_threads(1)

TOL = 2e-5                                  # tests/test_kernels.py
JAX_TOL = 1e-4                              # tests/test_torch_models.py
B, S, NEW = 4, 12, 4

_jforward = jax.jit(J.forward, static_argnames=("cfg", "mode"))
_jprefill = jax.jit(J.prefill, static_argnames=("cfg", "max_len"))
_jdecode = jax.jit(J.decode_step, static_argnames=("cfg",))


def _close(got, want, tol, **kw):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = want.numpy() if isinstance(want, torch.Tensor) else want
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, **kw)


def _mesh(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    with logical_devices(int(np.prod(shape)), "cpu"):
        return _make_mesh(shape, axes)


@functools.cache
def _setup(arch):
    """(port cfg, JAX params as numpy, inputs, JAX outputs): forward
    logits, prefill logits and the greedy stream's per-step logits."""
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(7)
    if cfg.input_mode == "embeds":
        inputs = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        steps = rng.standard_normal((NEW, B, 1, cfg.d_model)).astype(
            np.float32)
    else:
        inputs = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        steps = None
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    fwd, _ = _jforward(jp, jnp.asarray(inputs), jnp.asarray(pos), cfg=jcfg,
                       mode="score")
    logits, caches = _jprefill(jp, jnp.asarray(inputs), jnp.asarray(pos),
                               cfg=jcfg, max_len=S + NEW)
    stream = [np.asarray(logits)]
    for t in range(NEW):
        nxt = (jnp.asarray(steps[t]) if steps is not None
               else jnp.argmax(logits, -1).astype(jnp.int32))
        logits, caches = _jdecode(jp, caches, nxt,
                                  jnp.full((B, 1), S + t, jnp.int32),
                                  cfg=jcfg)
        stream.append(np.asarray(logits))
    return cfg, jp, inputs, steps, pos, np.asarray(fwd), stream


def _run(cfg, params, inputs, steps, pos, prog=None):
    """forward logits, and prefill + greedy decode logits, one device or
    over ``prog``'s mesh."""
    t = torch.from_numpy
    if prog is None:
        fwd, _ = P.forward(params, t(inputs), t(pos), cfg)
        logits, caches = P.prefill(params, t(inputs), t(pos), cfg,
                                   max_len=S + NEW)
    else:
        b = prog.place_batch({"inputs": t(inputs), "positions": t(pos)})
        fwd = prog.forward(params, b["inputs"], b["positions"]).gather("cpu")
        logits, caches = prog.prefill(params, b["inputs"], b["positions"],
                                      max_len=S + NEW)
        logits = logits.gather("cpu")
    stream = [logits]
    for i in range(NEW):
        nxt = (t(steps[i]) if steps is not None
               else logits.argmax(-1).to(torch.int32))
        p1 = torch.full((B, 1), S + i, dtype=torch.int32)
        if prog is None:
            logits, caches = P.decode_step(params, caches, nxt, p1, cfg)
        else:
            b = prog.place_batch({"inputs": nxt, "positions": p1})
            logits = prog.decode_step(params, caches, b["inputs"],
                                      b["positions"]).gather("cpu")
        stream.append(logits)
    return fwd, stream, caches


CASES = [("h2o-danube-1.8b", (1, 2)), ("h2o-danube-1.8b", (2, 1)),
         ("h2o-danube-1.8b", (2, 2)), ("gemma2-9b", (1, 4)),
         ("gemma2-9b", (2, 1, 2)), ("gemma3-4b", (2, 2)),
         ("mamba2-1.3b", (1, 2)), ("mamba2-1.3b", (2, 2)),
         ("zamba2-2.7b", (2, 2)), ("zamba2-2.7b", (2, 2, 2)),
         ("musicgen-large", (2, 2)), ("deepseek-moe-16b", (1, 2))]


@pytest.mark.parametrize("arch,shape", CASES)
def test_sharded_programs_equal_one_device_and_jax(arch, shape):
    """forward, prefill and every decode step over the mesh equal the
    port's one-device results and the JAX package's; the greedy streams
    are equal; the gathered caches equal the one-device caches; a second
    run is bit-equal (every reduction sums in shard order)."""
    cfg, jp, inputs, steps, pos, jfwd, jstream = _setup(arch)
    params = P.params_from_numpy(jp, cfg, "cpu")
    fwd1, stream1, caches1 = _run(cfg, params, inputs, steps, pos)
    prog = Program(cfg, _mesh(shape), batch=B)
    placed = prog.place_params(params)
    fwd, stream, caches = _run(cfg, placed, inputs, steps, pos, prog)
    _close(fwd, fwd1, TOL)
    _close(fwd, jfwd, JAX_TOL)
    for i, (a, b, c) in enumerate(zip(stream, stream1, jstream)):
        _close(a, b, TOL, err_msg=str(i))
        _close(a, c, JAX_TOL, err_msg=str(i))
        if steps is None:
            assert torch.equal(a.argmax(-1), b.argmax(-1))
            np.testing.assert_array_equal(a.argmax(-1).numpy(),
                                          c.argmax(-1))
    for (n, a), b in zip(named_leaves(prog.gather_caches(caches)),
                         tree_leaves(caches1)):
        _close(a.float(), b.float(), TOL, err_msg=n)
    again, stream2, _ = _run(cfg, placed, inputs, steps, pos, prog)
    assert torch.equal(again, fwd)
    assert all(torch.equal(a, b) for a, b in zip(stream, stream2))


def test_placement_round_trips_the_mamba_layout():
    """Mamba-2 leaves are placed in the shard-major layout (each shard's
    contiguous piece holds its heads' z, x, dt columns and 1/m of B|C) and
    gathered back bit for bit."""
    cfg = get_config("zamba2-2.7b", smoke=True)
    params = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prog = Program(cfg, _mesh((1, 2)))
    placed = prog.place_params(params)
    back = prog.gather_params(placed)
    for a, b in zip(tree_leaves(params), tree_leaves(back)):
        assert torch.equal(a, b)
    w = params["layers"][0]["mamba"]["in_proj"]
    local = placed["layers"][0]["mamba"]["in_proj"].shards[1]
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    hp = H // 2 * Pd
    assert torch.equal(local[:, :hp], w[:, hp:2 * hp])                 # z_1
    assert torch.equal(local[:, hp:2 * hp], w[:, di + hp:di + 2 * hp])  # x_1
    assert torch.equal(local[:, 2 * hp:2 * hp + N],
                       w[:, 2 * di + N:2 * di + 2 * N])                 # C
    assert torch.equal(local[:, -(H // 2):], w[:, -(H // 2):])          # dt_1


def _jstate(jcfg, name):
    opt = jopt.get_optimizer(name, lr=1e-2, **(
        {"warmup_steps": 1} if name == "adafactor" else {}))
    return opt, jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, opt)


def _flat(tree):
    return {n: t.float().numpy() for n, t in named_leaves(tree)}


@pytest.mark.parametrize("arch,shape,opt_name,accum", [
    ("h2o-danube-1.8b", (2, 2), "adamw", 1),
    ("h2o-danube-1.8b", (2, 2), "adafactor", 2),
    ("gemma2-9b", (1, 4), "adafactor", 1),
    ("gemma2-9b", (2, 1, 2), "adamw", 2),
    ("mamba2-1.3b", (2, 2), "adafactor", 1),
    ("zamba2-2.7b", (1, 2), "adamw", 2),
    ("zamba2-2.7b", (2, 2), "adafactor", 2)])
def test_sharded_train_step_equals_one_device_and_jax(arch, shape, opt_name,
                                                      accum):
    """Two sharded train steps (a masked batch of 8 over the rows) equal
    the one-device steps and JAX's: loss, CE, grad norm, step and every
    param and optimizer-state leaf."""
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jo, js = _jstate(jcfg, opt_name)
    opt = get_optimizer(opt_name, lr=1e-2, **(
        {"warmup_steps": 1} if opt_name == "adafactor" else {}))
    state = train_state_from_numpy(jax.tree.map(np.asarray, js), cfg, "cpu")
    mesh = _mesh(shape)
    prog = Program(cfg, mesh, batch=8)
    placed = prog.place_state(clone_state(state), opt.name)
    step1 = make_train_step(cfg, opt, grad_accum=accum)
    stepm = make_train_step(cfg, opt, grad_accum=accum, mesh=mesh)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jo, grad_accum=accum))
    batches = ShardedBatcher(cfg, DataConfig(batch=8, seq_len=S),
                             device="cpu")
    rng = np.random.default_rng(3)
    for i in range(2):
        batch = next(batches)
        batch["mask"] = torch.from_numpy(
            (rng.random((8, S)) > 0.3).astype(np.float32))
        js, jm = jstep(js, {k: jnp.asarray(v.numpy())
                            for k, v in batch.items()})
        state, m1 = step1(state, batch)
        placed, m = stepm(placed, prog.place_batch(batch))
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(m1[k]), rtol=TOL,
                                       err_msg=k)
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-4,
                                       err_msg=k)
        assert int(m["step"]) == int(m1["step"]) == int(jm["step"]) == i + 1
    got = _flat(prog.gather_state(placed))
    one = _flat(state)
    want = _flat(train_state_from_numpy(jax.tree.map(np.asarray, js), cfg,
                                        "cpu"))
    assert got.keys() == one.keys() == want.keys()
    for n in want:
        scale = float(np.abs(want[n]).max()) if want[n].size else 0.0
        np.testing.assert_allclose(got[n], one[n], rtol=2e-4,
                                   atol=2e-5 * max(scale, 1.0), err_msg=n)
        np.testing.assert_allclose(got[n], want[n], rtol=2e-4,
                                   atol=2e-5 * max(scale, 1.0), err_msg=n)


def test_f32_out_products_differentiate_on_the_card_route():
    """The card's bf16 partial products (``torch.mm(..., out_dtype=
    float32)``, which has no derivative) go through autograd Functions:
    on meta, which takes the card's route, a backward gives each operand
    a grad of its own shape and dtype."""
    from repro_torch.models.layers import matmul_f32, unembed

    x = torch.empty((2, 5, 8), dtype=torch.bfloat16,
                    device="meta").requires_grad_()
    w = torch.empty((8, 3), dtype=torch.bfloat16,
                    device="meta").requires_grad_()
    table = torch.empty((11, 8), dtype=torch.bfloat16,
                        device="meta").requires_grad_()
    y = matmul_f32(x, w)
    logits = unembed({"table": table}, x)
    assert y.dtype == logits.dtype == torch.float32
    gx, gw, gt = torch.autograd.grad(y.sum() + logits.sum(), (x, w, table))
    assert (gx.shape, gw.shape, gt.shape) == (x.shape, w.shape, table.shape)
    assert gx.dtype == gw.dtype == gt.dtype == torch.bfloat16


@pytest.mark.parametrize("arch,shape", [
    ("h2o-danube-1.8b", (2, 2)), ("gemma2-9b", (4, 1)),
    ("gemma2-9b", (2, 2, 2)), ("zamba2-2.7b", (2, 2)),
    ("deepseek-moe-16b", (2, 2)), ("llama4-maverick-400b-a17b", (2, 2, 2))])
def test_batch_one_decode_over_a_sequence_split_cache(arch, shape):
    """Stage 4: at batch 1 the rules split the decode caches' sequence
    over 'data' (a ring of window slots too); each row attends over its
    part through K4 and the parts merge by their log-sum-exps (the MoE
    configs' one token reaching its experts over 'data' too).  Four
    greedy steps from a one-device prefill equal the one-device steps and
    JAX's, and the gathered caches the one-device caches."""
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(0), jcfg))
    params = P.params_from_numpy(jp, cfg, "cpu")
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, S)).astype(np.int32)
    pos = np.arange(S, dtype=np.int32)[None]
    jl, jc = _jprefill(jp, jnp.asarray(toks), jnp.asarray(pos), cfg=jcfg,
                       max_len=S + NEW)
    logits, caches = P.prefill(params, torch.from_numpy(toks),
                               torch.from_numpy(pos), cfg, max_len=S + NEW)
    prog = Program(cfg, _mesh(shape), batch=1)
    assert len(prog.seq_rows) == shape[-2]
    placed = prog.place_params(params)
    split = prog.place_caches(caches)
    li = next(i for i, sp in enumerate(P.layer_specs(cfg))
              if sp.kind != "mamba")
    assert split[li]["k"].shards[0].shape[1] * shape[-2] == \
        caches[li]["k"].shape[1]
    nxt = logits.argmax(-1).to(torch.int32)
    for i in range(NEW):
        p1 = torch.full((1, 1), S + i, dtype=torch.int32)
        want, caches = P.decode_step(params, caches, nxt, p1, cfg)
        jl, jc = _jdecode(jp, jc, jnp.asarray(nxt.numpy()),
                          jnp.asarray(p1.numpy()), cfg=jcfg)
        b = prog.place_batch({"inputs": nxt, "positions": p1})
        got = prog.decode_step(placed, split, b["inputs"],
                               b["positions"]).gather("cpu")
        _close(got, want, TOL, err_msg=str(i))
        _close(got, np.asarray(jl), JAX_TOL, err_msg=str(i))
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        nxt = want.argmax(-1).to(torch.int32)
    for (n, a), b in zip(named_leaves(prog.gather_caches(split)),
                         tree_leaves(caches)):
        _close(a.float(), b.float(), TOL, err_msg=n)


@pytest.mark.parametrize("mesh_shape,batch", [((2, 2), 1), ((2, 2), 2),
                                              ((2, 2, 1), 4)])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gemma2-9b"])
def test_decode_over_caches_split_over_the_batch_and_sequence(
        arch, mesh_shape, batch):
    """Stage 4 at any batch: with ``seq_shard_cache`` the caches' sequence
    lies over 'data' and their batch over what is left of the batch axes
    (on (2, 2) nothing: each device holds every batch row of its part; on
    (2, 2, 1) 'pod'), while the inputs lie over 'data' (and 'pod').  The
    prefill of distinct prompts builds the split caches (equal to
    ``place_caches`` of the one-device prefill's); each batch region's
    rows then decode in lockstep over the whole region's batch, each batch
    row's parts merged by their log-sum-exps.  Four greedy steps equal
    the one-device steps and the JAX package's jitted ``decode_step`` at
    fp32: the same greedy stream."""
    from repro_torch.launch.sharding import make_rules

    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(0), jcfg))
    params = P.params_from_numpy(jp, cfg, "cpu")
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (batch, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (batch, 1))
    jl, jc = _jprefill(jp, jnp.asarray(toks), jnp.asarray(pos), cfg=jcfg,
                       max_len=S + NEW)
    want, caches = P.prefill(params, torch.from_numpy(toks),
                             torch.from_numpy(pos), cfg, max_len=S + NEW)
    mesh = _mesh(mesh_shape)
    prog = Program(cfg, mesh, rules=make_rules(cfg, mesh, batch=batch,
                                               seq_shard_cache=True))
    groups = 2 if len(mesh_shape) == 3 else 1
    assert len(prog.seq_groups) == groups
    assert all(len(g[2]) == 2 for g in prog.seq_groups)
    placed = prog.place_params(params)
    b = prog.place_batch({"inputs": torch.from_numpy(toks),
                          "positions": torch.from_numpy(pos)})
    logits, split = prog.prefill(placed, b["inputs"], b["positions"],
                                 max_len=S + NEW)
    logits = logits.gather("cpu")
    _close(logits, want, TOL)
    for (n, x), y in zip(named_leaves(split),
                         tree_leaves(prog.place_caches(caches))):
        assert x.placement.spec == y.placement.spec, n
        for u, v in zip(x.shards, y.shards):
            _close(u.float(), v.float(), TOL, err_msg=n)
    nxt = logits.argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jl).argmax(-1))
    for i in range(NEW):
        p1 = torch.full((batch, 1), S + i, dtype=torch.int32)
        jl, jc = _jdecode(jp, jc, jnp.asarray(nxt.numpy()),
                          jnp.asarray(p1.numpy()), cfg=jcfg)
        want, caches = P.decode_step(params, caches, nxt, p1, cfg)
        d = prog.place_batch({"inputs": nxt, "positions": p1})
        got = prog.decode_step(placed, split, d["inputs"],
                               d["positions"]).gather("cpu")
        _close(got, want, TOL, err_msg=str(i))
        _close(got, np.asarray(jl), JAX_TOL, err_msg=str(i))
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(jl).argmax(-1))
        nxt = got.argmax(-1).to(torch.int32)
    for (n, a), c in zip(named_leaves(prog.gather_caches(split)),
                         tree_leaves(caches)):
        _close(a.float(), c.float(), TOL, err_msg=n)


@pytest.mark.parametrize("arch,shape,batch,rules", [
    ("gemma2-9b", (2, 2), 1, None), ("gemma2-9b", (2, 2, 2), 1, None),
    ("zamba2-2.7b", (2, 2), 1, None), ("deepseek-moe-16b", (2, 2), 1, None),
    ("h2o-danube-1.8b", (2, 2), 4, {"cache_seq": "data"})])
def test_sequence_split_prefill_equals_the_placed_caches(arch, shape, batch,
                                                         rules):
    """Stage 4's prefill: caches split over the sequence (batch 1's rules,
    or a ``cache_seq`` override at batch 4, where each device's part
    spans both rows' batches) equal the one-device prefill's caches placed
    by the same rules, leaf by leaf and shard by shard (gemma2's rings of
    window slots split by slot, zamba2's Mamba-2 caches by the rules, the
    MoE config's one token reaching its experts over 'data'); the logits
    equal the one-device logits."""
    cfg = get_config(arch, smoke=True)
    one = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (batch, S)).astype(np.int32))
    pos = torch.arange(S, dtype=torch.int32)[None].repeat(batch, 1)
    want, caches = P.prefill(one, toks, pos, cfg, max_len=S + NEW)
    mesh = _mesh(shape)
    prog = Program(cfg, mesh, batch=batch)
    if rules:
        prog = Program(cfg, mesh, rules={**prog.rules, **rules})
    assert prog.seq_rows
    b = prog.place_batch({"inputs": toks, "positions": pos})
    logits, split = prog.prefill(prog.place_params(one), b["inputs"],
                                 b["positions"], max_len=S + NEW)
    _close(logits.gather("cpu"), want, TOL)
    placed = prog._place(caches, prog.cache_placements())
    for (n, a), c in zip(named_leaves(split), tree_leaves(placed)):
        assert (a.placement.spec, a.shape) == (c.placement.spec, c.shape), n
        for x, y in zip(a.shards, c.shards):
            assert x.shape == y.shape, n
            _close(x.float(), y.float(), TOL, err_msg=n)


def test_decode_attention_returns_the_parts_log_sum_exp():
    """K4's plain version (the CPU route) with ``lse``: the log-sum-exp of
    each row's visible scores (-inf with none), and two halves of a cache
    merged by theirs give the whole cache's output."""
    from repro_torch.kernels.decode_attention import ops

    g = torch.Generator().manual_seed(0)
    B, S, H, K, D = 3, 10, 4, 2, 8
    q = torch.randn((B, H, D), generator=g)
    k = torch.randn((B, S, K, D), generator=g)
    v = torch.randn((B, S, K, D), generator=g)
    cpos = torch.tensor([list(range(S)), [-1] * S,
                         list(range(5)) + [-1] * 5], dtype=torch.int32)
    qpos = torch.tensor([S - 1, 3, 4], dtype=torch.int32)
    out, lse = ops.decode_attention(q, k, v, qpos, cpos, softcap=5.0,
                                    lse=True)
    assert torch.equal(out, ops.decode_attention(q, k, v, qpos, cpos,
                                                 softcap=5.0))
    s = torch.einsum("bkgd,bskd->bkgs", q.reshape(B, K, H // K, D),
                     k) * D ** -0.5
    s = 5.0 * torch.tanh(s / 5.0)
    vis = ((cpos >= 0) & (cpos <= qpos[:, None]))[:, None, None, :]
    want = torch.logsumexp(s.masked_fill(~vis, float("-inf")), dim=-1)
    assert torch.isinf(lse[1]).all() and (lse[1] < 0).all()
    np.testing.assert_allclose(lse[[0, 2]].numpy(),
                               want.reshape(B, H)[[0, 2]].numpy(),
                               rtol=1e-6, atol=1e-6)
    halves = [ops.decode_attention(q, k[:, sl].contiguous(),
                                   v[:, sl].contiguous(), qpos,
                                   cpos[:, sl].contiguous(), softcap=5.0,
                                   lse=True)
              for sl in (slice(0, 5), slice(5, S))]
    from repro_torch.models.attention import _seq_merge

    merged = _seq_merge([h[0] for h in halves], [h[1] for h in halves],
                        (2, 1), q.dtype)
    _close(merged[[0, 2]], out[[0, 2]], TOL)


def test_sequence_split_prefill_and_experts_over_data_run():
    """Stages 4 and 5 run.  Stage 4's prefill: at
    batch 1 the rules split the caches' sequence over 'data', and
    ``Program.prefill`` builds them split (the first row's program, each
    device keeping its part): they equal ``place_caches`` of the
    one-device prefill, and 8 greedy decode steps over them give the JAX
    package's stream.  Experts over 'data' (Stage 5): deepseek-moe-16b's
    forward on (2, 1) runs and equals the one-device forward."""
    new = 8
    arch = "h2o-danube-1.8b"
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(0), jcfg))
    one = P.params_from_numpy(jp, cfg, "cpu")
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, S)).astype(np.int32)
    pos = np.arange(S, dtype=np.int32)[None]
    jl, jc = _jprefill(jp, jnp.asarray(toks), jnp.asarray(pos), cfg=jcfg,
                       max_len=S + new)
    want, caches = P.prefill(one, torch.from_numpy(toks),
                             torch.from_numpy(pos), cfg, max_len=S + new)
    prog = Program(cfg, _mesh((2, 2)), batch=1)
    assert len(prog.seq_rows) == 2
    params = prog.place_params(one)
    b1 = prog.place_batch({"inputs": torch.from_numpy(toks),
                           "positions": torch.from_numpy(pos)})
    logits, split = prog.prefill(params, b1["inputs"], b1["positions"],
                                 max_len=S + new)
    _close(logits.gather("cpu"), want, TOL)
    placed = prog.place_caches(caches)
    for (n, a), b in zip(named_leaves(split), tree_leaves(placed)):
        assert a.placement.spec == b.placement.spec and a.shape == b.shape
        for x, y in zip(a.shards, b.shards):
            assert x.shape == y.shape, n
            _close(x.float(), y.float(), TOL, err_msg=n)
    nxt = logits.gather("cpu").argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jl).argmax(-1))
    for i in range(new):
        p1 = torch.full((1, 1), S + i, dtype=torch.int32)
        jl, jc = _jdecode(jp, jc, jnp.asarray(nxt.numpy()),
                          jnp.asarray(p1.numpy()), cfg=jcfg)
        b = prog.place_batch({"inputs": nxt, "positions": p1})
        got = prog.decode_step(params, split, b["inputs"],
                               b["positions"]).gather("cpu")
        _close(got, np.asarray(jl), JAX_TOL, err_msg=str(i))
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(jl).argmax(-1))
        nxt = got.argmax(-1).to(torch.int32)
    moe = get_config("deepseek-moe-16b", smoke=True)
    prog = Program(moe, _mesh((2, 1)), batch=4)
    one = P.init_params(moe, torch.Generator().manual_seed(0), "cpu")
    params = prog.place_params(one)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, moe.vocab_size, (4, 8)).astype(np.int32))
    pos = torch.arange(8, dtype=torch.int32)[None].repeat(4, 1)
    b = prog.place_batch({"inputs": toks, "positions": pos})
    got = prog.forward(params, b["inputs"], b["positions"]).gather("cpu")
    _close(got, P.forward(one, toks, pos, moe)[0], TOL)


def test_a_serving_slice_with_data_rows_still_raises():
    """The engine serves over a (data=1, model=m) slice only."""
    cfg = get_config("gemma2-9b", smoke=True)
    params = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="a serving slice is"):
        ServeEngine(cfg, params, device="cpu", mesh=_mesh((2, 1)))


def test_one_device_step_updates_the_given_state_in_place():
    """Without a mesh the step is ``Program``'s over a one-device mesh of
    the state's device, whose placement holds the given tensors: the state
    it returns holds the same param and moment tensors, updated."""
    cfg = get_config("h2o-danube-1.8b", smoke=True)
    opt = get_optimizer("adamw", lr=1e-2)
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                             device="cpu")
    before = clone_state(state)
    batch = next(ShardedBatcher(cfg, DataConfig(batch=2, seq_len=S),
                                device="cpu"))
    new, m = make_train_step(cfg, opt)(state, batch)
    assert all(a is b for a, b in zip(tree_leaves(new.params),
                                      tree_leaves(state.params)))
    assert all(a is b for a, b in zip(tree_leaves(new.opt_state.mu),
                                      tree_leaves(state.opt_state.mu)))
    assert int(new.opt_state.step) == int(m["step"]) == 1
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(new.params), tree_leaves(before.params)))


def test_the_gradient_reduction_over_rows_is_load_bearing():
    """The control the card's train check plants: a program whose
    gradient reduction keeps only the first batch row's part
    (``Program._grad_parts``) moves the state away from the sound one."""
    class DropRowGrads(Program):
        def _grad_parts(self, acc, j, shards, rows):
            return super()._grad_parts(acc, j, shards, rows[:1])

    cfg = get_config("h2o-danube-1.8b", smoke=True)
    opt = get_optimizer("adamw", lr=1e-2)
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                             device="cpu")
    batch = next(ShardedBatcher(cfg, DataConfig(batch=4, seq_len=S),
                                device="cpu"))
    norms = []
    for cls in (Program, DropRowGrads):
        prog = cls(cfg, _mesh((2, 2)), batch=4)
        placed = prog.place_state(clone_state(state), opt.name)
        _, m = prog.train_step(opt)(placed, prog.place_batch(batch))
        norms.append(float(m["grad_norm"]))
    assert abs(norms[1] - norms[0]) > 0.05 * norms[0], norms


def test_only_meta_tensors_stand_in_for_shards_that_did_not_run():
    """``slices.tiled`` repeats the pieces that ran over the group only for
    the dry run's meta tensors; anywhere else a missing shard raises."""
    from repro_torch.models import slices

    assert len(slices.tiled([torch.empty((2, 3), device="meta")], 4)) == 4
    with pytest.raises(ValueError, match="stand in"):
        slices.tiled([torch.zeros((2, 3))], 4)
