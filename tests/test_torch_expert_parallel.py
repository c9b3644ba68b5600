"""Port parity: the MoE configs' sharded programs with the experts over
'data' (``launch.spmd.Program`` with coupled rows, ``models.moe.
RowExperts``) against the port's one-device programs and the JAX
package's unsharded functions, on the CPU.

deepseek-moe-16b SMOKE (8 experts, top-2, two shared; also at top-6) and
llama4-maverick SMOKE (8 experts, top-1, one shared) run on (data,
model) meshes of (2, 1), (2, 2) and (4, 1) and the (pod, data, model)
mesh (2, 2, 1) of logical CPU devices.  Each row routes its own tokens in
the batch's groups, places each entry after the entries that the rows
before gave its expert, and sends each slice of its buffer to the row
that owns those experts.  A batch of 4 x 12 is one group of 48 over the
rows; B 2 x S 800 is three groups of 533, the second straddling the two
rows, and one token of ragged tail (ROADMAP F10) in the last row;
``moe_impl="scatter"`` is one group of all tokens.  Controls: counting
places per row, and Adafactor's update clip over each row alone, must
differ.  Tolerances as in ``tests/test_torch_sharded_steps.py``: 2e-5
against one device, 1e-4 against JAX (rtol, and atol times the largest
magnitude); train states at the training suite's leaf tolerances.
"""
import importlib

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
from repro_torch.core.sharded import current_shard
from repro_torch.launch.mesh import _make_mesh, logical_devices
from repro_torch.launch.spmd import Program
from repro_torch.training import (DataConfig, ShardedBatcher, clone_state,
                                  get_optimizer, make_train_step,
                                  train_state_from_numpy)
from repro_torch.tree import named_leaves

pmoe = importlib.import_module("repro_torch.models.moe")

torch.set_num_threads(1)

TOL = 2e-5                                  # tests/test_kernels.py
JAX_TOL = 1e-4                              # tests/test_torch_models.py
NEW = 4
ARCHS = ("deepseek-moe-16b", "llama4-maverick-400b-a17b")

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


def _setup(arch, B, S, decode=True, **over):
    """(port cfg, JAX params as numpy, tokens, positions, JAX forward
    logits, JAX prefill + greedy decode logits)."""
    jcfg = jget_config(arch, smoke=True).replace(**over)
    cfg = get_config(arch, smoke=True).replace(**over)
    jp = jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(0), jcfg))
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    fwd, _ = _jforward(jp, jnp.asarray(toks), jnp.asarray(pos), cfg=jcfg,
                       mode="score")
    stream = []
    if decode:
        logits, caches = _jprefill(jp, jnp.asarray(toks), jnp.asarray(pos),
                                   cfg=jcfg, max_len=S + NEW)
        stream.append(np.asarray(logits))
        for t in range(NEW):
            nxt = jnp.argmax(logits, -1).astype(jnp.int32)
            logits, caches = _jdecode(jp, caches, nxt,
                                      jnp.full((B, 1), S + t, jnp.int32),
                                      cfg=jcfg)
            stream.append(np.asarray(logits))
    return cfg, jp, toks, pos, np.asarray(fwd), stream


def _run(cfg, params, toks, pos, prog=None, decode=True):
    """forward logits, and prefill + greedy decode logits, one device or
    over ``prog``'s mesh."""
    t = torch.from_numpy
    B, S = toks.shape
    if prog is None:
        fwd, _ = P.forward(params, t(toks), t(pos), cfg)
    else:
        b = prog.place_batch({"inputs": t(toks), "positions": t(pos)})
        fwd = prog.forward(params, b["inputs"], b["positions"]).gather("cpu")
    if not decode:
        return fwd, []
    if prog is None:
        logits, caches = P.prefill(params, t(toks), t(pos), cfg,
                                   max_len=S + NEW)
    else:
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


def _check(arch, shape, B, S, decode=True, **over):
    cfg, jp, toks, pos, jfwd, jstream = _setup(arch, B, S, decode, **over)
    params = P.params_from_numpy(jp, cfg, "cpu")
    fwd1, stream1 = _run(cfg, params, toks, pos, decode=decode)
    prog = Program(cfg, _mesh(shape), batch=B)
    assert prog.coupled
    placed = prog.place_params(params)
    w = placed["layers"][1]["moe"]["w_gate"]
    assert w.shards[0].shape[0] * shape[-2] == cfg.n_experts    # over 'data'
    fwd, stream = _run(cfg, placed, toks, pos, prog, decode)
    _close(fwd, fwd1, TOL)
    _close(fwd, jfwd, JAX_TOL)
    for i, (a, b, c) in enumerate(zip(stream, stream1, jstream)):
        _close(a, b, TOL, err_msg=str(i))
        _close(a, c, JAX_TOL, err_msg=str(i))
        assert torch.equal(a.argmax(-1), b.argmax(-1))
        np.testing.assert_array_equal(a.argmax(-1).numpy(), c.argmax(-1))
    again, stream2 = _run(cfg, placed, toks, pos, prog, decode)
    assert torch.equal(again, fwd)
    assert all(torch.equal(a, b) for a, b in zip(stream, stream2))
    return cfg, params, prog, placed, toks, pos, fwd1


@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (4, 1), (2, 2, 1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_experts_over_data_equal_one_device_and_jax(arch, shape):
    """forward, prefill and four greedy decode steps (each a group of 4
    tokens across the rows) with the experts over 'data' equal the port's
    one-device results and the JAX package's; the greedy streams are
    equal and a second run is bit-equal."""
    _check(arch, shape, 4, 12)


def test_deepseek_at_top_six_over_data():
    """deepseek-moe-16b's own top-6 (of the SMOKE config's 8 experts) on
    (2, 2): six entries a token in each expert's buffer of 45."""
    _check("deepseek-moe-16b", (2, 2), 4, 12, top_k=6)


def test_a_group_straddling_the_rows_and_the_tail():
    """B 2 x S 800 on (2, 1): groups of 533 tokens (the second straddles
    the rows, row 1 placing its entries after row 0's) and one F10 tail
    token in row 1, which gets no routed output.  A control that counts
    places within each row alone drops other entries and differs."""
    cfg, params, prog, placed, toks, pos, fwd1 = _check(
        "deepseek-moe-16b", (2, 1), 2, 800, decode=False)
    assert pmoe.groups(2 * 800, cfg) == (3, 533)
    b = prog.place_batch({"inputs": torch.from_numpy(toks),
                          "positions": torch.from_numpy(pos)})
    carry_in = pmoe.RowExperts.carry_in
    try:
        pmoe.RowExperts.carry_in = lambda self, li: None
        per_row = prog.forward(placed, b["inputs"], b["positions"]).gather(
            "cpu")
    finally:
        pmoe.RowExperts.carry_in = carry_in
    # group 0 (tokens 0..532) is row 0's alone; in the straddling group
    # (533..1065) each row's entries, counted from 0, take the same slots
    # of the owner's one buffer, so both rows' tokens there get another
    # token's output, and attention carries the change to later tokens
    assert torch.equal(per_row[0, :533], fwd1[0, :533])
    for r, tail in ((0, slice(533, 800)), (1, slice(0, 800))):
        diff = float((per_row[r, tail] - fwd1[r, tail]).abs().max())
        assert diff > 100 * TOL * float(fwd1.abs().max()), (r, diff)


def test_scatter_dispatch_over_data():
    """``moe_impl="scatter"`` (one group of all N tokens) on (2, 2)."""
    _check("llama4-maverick-400b-a17b", (2, 2), 4, 12, moe_impl="scatter")


def _jstate(jcfg, name):
    opt = jopt.get_optimizer(name, lr=1e-2, **(
        {"warmup_steps": 1} if name == "adafactor" else {}))
    return opt, jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, opt)


def _flat(tree):
    return {n: t.float().numpy() for n, t in named_leaves(tree)}


def _train(arch, shape, opt_name, accum, prog_cls=Program, steps=2):
    """Sharded, one-device and JAX train steps on the same masked
    batches of 8: (each step's metrics, and the final states' leaves)."""
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jo, js = _jstate(jcfg, opt_name)
    opt = get_optimizer(opt_name, lr=1e-2, **(
        {"warmup_steps": 1} if opt_name == "adafactor" else {}))
    state = train_state_from_numpy(jax.tree.map(np.asarray, js), cfg, "cpu")
    mesh = _mesh(shape)
    prog = prog_cls(cfg, mesh, batch=8)
    placed = prog.place_state(clone_state(state), opt.name)
    step1 = make_train_step(cfg, opt, grad_accum=accum)
    stepm = prog.train_step(opt, grad_accum=accum)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jo, grad_accum=accum))
    batches = ShardedBatcher(cfg, DataConfig(batch=8, seq_len=12),
                             device="cpu")
    rng = np.random.default_rng(3)
    metrics = []
    for _ in range(steps):
        batch = next(batches)
        batch["mask"] = torch.from_numpy(
            (rng.random((8, 12)) > 0.3).astype(np.float32))
        js, jm = jstep(js, {k: jnp.asarray(v.numpy())
                            for k, v in batch.items()})
        state, m1 = step1(state, batch)
        placed, m = stepm(placed, prog.place_batch(batch))
        metrics.append((m, m1, jm))
    return (metrics, _flat(prog.gather_state(placed)), _flat(state),
            _flat(train_state_from_numpy(jax.tree.map(np.asarray, js), cfg,
                                         "cpu")))


@pytest.mark.parametrize("arch,shape,opt_name,accum", [
    ("deepseek-moe-16b", (2, 2), "adamw", 1),
    ("deepseek-moe-16b", (2, 1, 2), "adamw", 2),
    ("llama4-maverick-400b-a17b", (2, 2), "adafactor", 2)])
def test_train_steps_with_experts_over_data(arch, shape, opt_name, accum):
    """Two sharded train steps (each reference microbatch's pieces forward
    in token order, one backward over its loss, the aux formed from every
    piece's sums; an expert leaf's gradient its owners' alone) equal the
    one-device steps and JAX's: loss, CE, aux loss, grad norm, step and
    every param and optimizer-state leaf."""
    metrics, got, one, want = _train(arch, shape, opt_name, accum)
    for i, (m, m1, jm) in enumerate(metrics):
        for k in ("loss", "ce", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(m1[k]), rtol=TOL,
                                       err_msg=k)
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-4,
                                       err_msg=k)
        assert int(m["step"]) == int(m1["step"]) == int(jm["step"]) == i + 1
    assert got.keys() == one.keys() == want.keys()
    for n in want:
        scale = float(np.abs(want[n]).max()) if want[n].size else 0.0
        np.testing.assert_allclose(got[n], one[n], rtol=2e-4,
                                   atol=2e-5 * max(scale, 1.0), err_msg=n)
        np.testing.assert_allclose(got[n], want[n], rtol=2e-4,
                                   atol=2e-5 * max(scale, 1.0), err_msg=n)


def test_adafactor_clip_over_each_row_alone_differs():
    """The control: Adafactor's update clip with its RMS over each data
    row's shards alone (no leaf spread over the rows) moves the expert
    leaves away from the one-device state, and only them."""
    class PerRowClip(Program):
        def spread(self):
            return set()

    _, got, one, _ = _train("llama4-maverick-400b-a17b", (2, 2),
                            "adafactor", 2, PerRowClip, steps=1)
    worst = {}
    for n in one:
        den = max(float(np.abs(one[n]).max()), 1e-30)
        worst[n] = float(np.abs(got[n] - one[n]).max()) / den
    experts = [n for n in worst if "/moe/w_" in n and n.startswith("params")]
    assert experts and max(worst[n] for n in experts) > 1e-3, worst
    rest = [n for n in worst if "/moe/w_" not in n]
    assert max(worst[n] for n in rest) < 1e-4, worst


def _apart(calls, plans):
    """The former design of ``moe._owner_ffn``: each row's slices of its
    buffer run by their owners one row at a time (all E · C of a group's
    slots a row)."""
    out = []
    for (_, _, ex), (_, xe) in zip(calls, plans):
        e = xe.shape[0] // len(ex.row.owners)
        ys = []
        for o, shards in enumerate(ex.row.owners):
            own = shards[ex.shard]
            ys.append(pmoe._expert_ffn(own.tree["layers"][ex.li]["moe"],
                                       xe[o * e:(o + 1) * e]))
        out.append(torch.cat(ys))
    return out


def _places(plans, E):
    """Each entry's (expert, group, place) of the plans (a layer's, in
    token order), -1 for a dropped entry, and its fit."""
    out = []
    for p in plans:
        G, C = p.groups, p.capacity
        row = p.row.long()
        kept = row < E * G * C
        where = torch.stack([row // (G * C), (row // C) % G + p.group0,
                             row % C], dim=-1)
        out.append(torch.where(kept[..., None], where, -1))
    return torch.cat(out), torch.cat([p.keep for p in plans])


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_an_owner_runs_a_group_spanning_the_rows_once(shape, monkeypatch):
    """F17: B 4 x S 12 is one group of 48 tokens over both rows.  Each
    owner device runs it once a MoE layer, over its E/rows experts and the
    group's C slots (the former design ran all E · C slots for each row);
    routing choices and place counts equal the one-device program's; the
    logits and aux are bit-equal to the former design's and within 2e-5
    of one device's."""
    cfg = get_config("deepseek-moe-16b", smoke=True)
    one = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 12)).astype(np.int32))
    pos = torch.arange(12, dtype=torch.int32)[None].repeat(4, 1)
    prog = Program(cfg, _mesh(shape), batch=4)
    placed = prog.place_params(one)
    b = prog.place_batch({"inputs": toks, "positions": pos})
    rows = list(range(prog.n_rows))
    n_moe = sum(s.kind == "attn_moe" for s in P.layer_specs(cfg))
    slots: list = []
    plans: list = []
    ffn, plan = pmoe._expert_ffn, pmoe.dispatch_plan

    def spy_ffn(params, xe):
        slots.append(xe.shape[0] * xe.shape[1])
        return ffn(params, xe)

    def spy_plan(*a, **kw):
        out = plan(*a, **kw)
        if current_shard() in (None, 0):
            plans.append(out)
        return out

    with monkeypatch.context() as mp:
        mp.setattr(pmoe, "_expert_ffn", spy_ffn)
        mp.setattr(pmoe, "dispatch_plan", spy_plan)
        got = prog.forward(placed, b["inputs"], b["positions"], rows=rows)
        mine, plans, ran = plans, [], list(slots)
        want, _ = P.forward(one, toks, pos, cfg)
    C = pmoe.capacity(48, cfg)
    assert pmoe.groups(48, cfg) == (1, 48)
    assert ran == [cfg.n_experts // 2 * C] * (n_moe * prog.mesh.size)
    for li in range(n_moe):
        layer = mine[li * 2:(li + 1) * 2]        # the rows, in token order
        a, ka = _places(layer, cfg.n_experts)
        w, kw = _places(plans[li:li + 1], cfg.n_experts)
        assert torch.equal(a, w) and torch.equal(ka, kw), li
    logits = torch.cat([got[r][0] for r in rows])
    _close(logits, want, TOL)
    with monkeypatch.context() as mp:
        mp.setattr(pmoe, "_owner_ffn", _apart)
        old = prog.forward(placed, b["inputs"], b["positions"], rows=rows)
    for r in rows:
        assert torch.equal(got[r][0], old[r][0])
        assert torch.equal(got[r][1], old[r][1])
