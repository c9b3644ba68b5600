"""Port parity: params over 'data' (the reference's ``make_rules(...,
fsdp=True)``: ``embed`` over 'data') in the sharded programs
(``launch.spmd.Program``), against the same mesh's programs without it,
the port's one-device programs and the JAX package's unsharded functions,
on the CPU.

SMOKE configs on logical CPU devices: h2o-danube-1.8b, gemma2-9b (window,
softcaps), zamba2-2.7b (shard-major Mamba-2 columns, ``embed`` over
'data') and deepseek-moe-16b (the experts and ``embed`` both over 'data'),
on (data, model) (2, 2) and (pod, data, model) (2, 2, 1).  Every leaf
split over 'data' on a dim that is not the experts' is gathered whole at
its use; a train step hands each row's whole gradient of it to the
program, which sums the rows' gradients in the order of a replicated
leaf's and keeps each device's slice (a reduce-scatter), so each slice of
a summed gradient is the same bits as the step without fsdp.  Tolerances
as in ``tests/test_torch_sharded_steps.py``: 2e-5 against one device,
1e-4 against JAX (rtol, and atol times the largest magnitude); train
states at the training suite's leaf tolerances.
"""
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
from repro_torch.launch.sharding import make_rules
from repro_torch.launch.spmd import Program
from repro_torch.training import (DataConfig, ShardedBatcher, clone_state,
                                  get_optimizer, make_train_step,
                                  train_state_from_numpy)
from repro_torch.tree import named_leaves

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


def _program(cfg, mesh, batch, fsdp, cls=Program):
    return cls(cfg, mesh, rules=make_rules(cfg, mesh, batch=batch,
                                           fsdp=fsdp))


def _run(cfg, params, toks, pos, prog=None):
    """forward logits, and prefill + greedy decode logits, one device or
    over ``prog``'s mesh."""
    t = torch.from_numpy
    if prog is None:
        fwd, _ = P.forward(params, t(toks), t(pos), cfg)
        logits, caches = P.prefill(params, t(toks), t(pos), cfg,
                                   max_len=S + NEW)
    else:
        b = prog.place_batch({"inputs": t(toks), "positions": t(pos)})
        fwd = prog.forward(params, b["inputs"], b["positions"]).gather("cpu")
        logits, caches = prog.prefill(params, b["inputs"], b["positions"],
                                      max_len=S + NEW)
        logits = logits.gather("cpu")
    stream = [logits]
    for i in range(NEW):
        nxt = logits.argmax(-1).to(torch.int32)
        p1 = torch.full((B, 1), S + i, dtype=torch.int32)
        if prog is None:
            logits, caches = P.decode_step(params, caches, nxt, p1, cfg)
        else:
            b = prog.place_batch({"inputs": nxt, "positions": p1})
            logits = prog.decode_step(params, caches, b["inputs"],
                                      b["positions"]).gather("cpu")
        stream.append(logits)
    return fwd, stream


@pytest.mark.parametrize("shape", [(2, 2), (2, 2, 1)])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gemma2-9b",
                                  "zamba2-2.7b", "deepseek-moe-16b"])
def test_fsdp_programs_equal_one_device_and_jax(arch, shape):
    """forward, prefill and four greedy decode steps with ``embed`` over
    'data' equal the same mesh's programs without it bit for bit (the
    gathered leaves are the replicated ones), the port's one-device
    results and the JAX package's; the greedy streams are equal."""
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(0), jcfg))
    params = P.params_from_numpy(jp, cfg, "cpu")
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jfwd, _ = _jforward(jp, jnp.asarray(toks), jnp.asarray(pos), cfg=jcfg,
                        mode="score")
    logits, caches = _jprefill(jp, jnp.asarray(toks), jnp.asarray(pos),
                               cfg=jcfg, max_len=S + NEW)
    jstream = [np.asarray(logits)]
    for i in range(NEW):
        logits, caches = _jdecode(jp, caches,
                                  jnp.argmax(logits, -1).astype(jnp.int32),
                                  jnp.full((B, 1), S + i, jnp.int32),
                                  cfg=jcfg)
        jstream.append(np.asarray(logits))
    mesh = _mesh(shape)
    prog = _program(cfg, mesh, B, True)
    assert prog.gathered and "embed/table" in prog.gathered
    placed = prog.place_params(params)
    w = placed["layers"][0]["attn" if arch != "zamba2-2.7b" else "mamba"]
    leaf = w["wq" if arch != "zamba2-2.7b" else "in_proj"]
    assert leaf.shards[0].shape[0] * shape[-2] == cfg.d_model  # over 'data'
    fwd, stream = _run(cfg, placed, toks, pos, prog)
    plain = _program(cfg, mesh, B, False)
    fwd0, stream0 = _run(cfg, plain.place_params(params), toks, pos, plain)
    fwd1, stream1 = _run(cfg, params, toks, pos)
    assert torch.equal(fwd, fwd0)
    assert all(torch.equal(a, b) for a, b in zip(stream, stream0))
    _close(fwd, fwd1, TOL)
    _close(fwd, jfwd, JAX_TOL)
    for i, (a, b, c) in enumerate(zip(stream, stream1, jstream)):
        _close(a, b, TOL, err_msg=str(i))
        _close(a, c, JAX_TOL, err_msg=str(i))
        assert torch.equal(a.argmax(-1), b.argmax(-1))
        np.testing.assert_array_equal(a.argmax(-1).numpy(), c.argmax(-1))


class _Spy(Program):
    """A Program that keeps each step's summed gradients, before the
    clip (``Program._reduce``)."""

    def _reduce(self, *args):
        out = super()._reduce(*args)
        self.seen.append({i: [g.clone() for g in gl]
                          for i, gl in out.items()})
        return out


class _DropRowScatter(_Spy):
    """The control: a reduce-scatter that keeps the first batch row's part
    of every gathered leaf only."""

    def _scatter_parts(self, acc, j, shards, rows, cut):
        return super()._scatter_parts(acc, j, shards, rows[:1], cut)


def _opt(name):
    kw = {"warmup_steps": 1} if name == "adafactor" else {}
    return (get_optimizer(name, lr=1e-2, **kw),
            jopt.get_optimizer(name, lr=1e-2, **kw))


def _train(arch, shape, opt_name, accum, classes=(_Spy, _Spy)):
    """Two masked train steps of a batch of 8, without and with fsdp on the
    same mesh (``classes``), one device and JAX: (each run's program,
    gathered state and metrics)."""
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    opt, jo = _opt(opt_name)
    js = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, jo)
    state = train_state_from_numpy(jax.tree.map(np.asarray, js), cfg, "cpu")
    mesh = _mesh(shape)
    batches = ShardedBatcher(cfg, DataConfig(batch=8, seq_len=S),
                             device="cpu")
    rng = np.random.default_rng(3)
    data = []
    for _ in range(2):
        b = next(batches)
        b["mask"] = torch.from_numpy(
            (rng.random((8, S)) > 0.3).astype(np.float32))
        data.append(b)
    runs = {}
    for fsdp, cls in zip((False, True), classes):
        prog = _program(cfg, mesh, 8, fsdp, cls)
        prog.seen = []
        placed = prog.place_state(clone_state(state), opt.name)
        step = prog.train_step(opt, grad_accum=accum)
        ms = []
        for b in data:
            placed, m = step(placed, prog.place_batch(b))
            ms.append(m)
        runs[fsdp] = (prog, placed, ms)
    one, m1 = state, []
    step1 = make_train_step(cfg, opt, grad_accum=accum)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jo, grad_accum=accum))
    jm = []
    for b in data:
        one, m = step1(one, b)
        m1.append(m)
        js, m = jstep(js, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        jm.append(m)
    want = train_state_from_numpy(jax.tree.map(np.asarray, js), cfg, "cpu")
    return runs, (one, m1), (want, jm)


def _slice_diffs(runs, step: int) -> list:
    """The gathered leaves' summed-gradient slices of step ``step`` (fsdp)
    against the same regions of the step without fsdp: the (device, leaf)
    pairs that differ in any bit, and how many were compared."""
    p0, s0, _ = runs[False]
    p1, s1, _ = runs[True]
    names = [n for n, _ in named_leaves(p1.param_placements)]
    r0, r1 = p0._regions(s0.params), p1._regions(s1.params)
    bad, n = [], 0
    for i, grads in p1.seen[step].items():
        for j, name in enumerate(names):
            if name not in p1.gathered:
                continue
            cut = tuple(slice(a - c, b - c) for (a, b), (c, _) in
                        zip(r1[j][i], r0[j][i]))
            n += 1
            if not torch.equal(grads[j], p0.seen[step][i][j][cut]):
                bad.append((i, name))
    return bad, n


@pytest.mark.parametrize("arch,shape,opt_name,accum", [
    ("h2o-danube-1.8b", (2, 2), "adamw", 1),
    ("h2o-danube-1.8b", (2, 2, 1), "adafactor", 2),
    ("gemma2-9b", (2, 2), "adafactor", 1),
    ("zamba2-2.7b", (2, 2), "adamw", 2),
    ("deepseek-moe-16b", (2, 2), "adamw", 1)])
def test_fsdp_train_step_sums_each_slice_as_the_replicated_step(
        arch, shape, opt_name, accum):
    """Two fsdp train steps: each device's slice of every gathered leaf's
    summed gradient in the first step is bit-equal to the same region of
    the step without fsdp (the later steps start from a state whose clip
    read a global norm summed slice by slice, in another order); loss,
    CE, aux, grad norm and every param and optimizer-state leaf equal the
    one-device steps' and JAX's."""
    runs, (one, m1), (want, jm) = _train(arch, shape, opt_name, accum)
    bad, n = _slice_diffs(runs, 0)
    assert n and not bad, bad
    p1, s1, ms = runs[True]
    got = {k: t.float().numpy() for k, t in
           named_leaves(p1.gather_state(s1))}
    for i, (m, a, j) in enumerate(zip(ms, m1, jm)):
        for k in ("loss", "ce", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(a[k]), rtol=TOL,
                                       err_msg=k)
            np.testing.assert_allclose(float(m[k]), float(j[k]), rtol=2e-4,
                                       err_msg=k)
        assert int(m["step"]) == int(a["step"]) == int(j["step"]) == i + 1
    one = {k: t.float().numpy() for k, t in named_leaves(one)}
    want = {k: t.float().numpy() for k, t in named_leaves(want)}
    assert got.keys() == one.keys() == want.keys()
    for k in want:
        scale = float(np.abs(want[k]).max()) if want[k].size else 0.0
        np.testing.assert_allclose(got[k], one[k], rtol=2e-4,
                                   atol=2e-5 * max(scale, 1.0), err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4,
                                   atol=2e-5 * max(scale, 1.0), err_msg=k)


def test_a_reduce_scatter_dropping_a_row_fails_the_check():
    """The control: a reduce-scatter that keeps only the first batch row's
    part of each gathered leaf leaves every gathered slice unequal to the
    step without fsdp, and moves the gradient norm away from it."""
    runs, _, _ = _train("h2o-danube-1.8b", (2, 2), "adamw", 1,
                        classes=(_Spy, _DropRowScatter))
    bad, n = _slice_diffs(runs, 0)
    assert len(bad) == n > 0
    norms = [float(runs[f][2][0]["grad_norm"]) for f in (False, True)]
    assert abs(norms[1] - norms[0]) > 0.05 * norms[0], norms


def test_fsdp_gathers_each_use_and_records_its_collectives():
    """Under fsdp a step's ledger holds an all-gather for each gathered
    use (remat's recompute gathers again) and a reduce-scatter for each
    gathered leaf; the placed params hold a 'data' share of every
    gathered leaf."""
    from repro_torch.core.sharded import collectives

    cfg = get_config("h2o-danube-1.8b", smoke=True)
    mesh = _mesh((2, 2))
    counts = {}
    for fsdp in (False, True):
        prog = _program(cfg, mesh, 8, fsdp)
        opt = get_optimizer("adamw", lr=1e-2)
        state = prog.init_state(opt, prog.place_params(P.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu")))
        batch = prog.place_batch(next(ShardedBatcher(
            cfg, DataConfig(batch=8, seq_len=S), device="cpu")))
        with collectives() as ledger:
            prog.train_step(opt)(state, batch)
        counts[fsdp] = (dict(ledger.bytes), prog)
    plain, (fsdp, prog) = counts[False][0], counts[True]
    assert plain["all-gather"] < fsdp["all-gather"]
    assert plain["reduce-scatter"] == 0 < fsdp["reduce-scatter"]
    params = prog.place_params(P.init_params(cfg, device="meta"))
    for name, leaf in named_leaves(params):
        g = prog.gathered.get(name)
        if g is not None:
            assert leaf.shards[0].shape[g.dim] * 2 == leaf.shape[g.dim]
