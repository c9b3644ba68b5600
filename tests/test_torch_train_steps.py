"""Port parity for the train step, the optimizers, checkpoints and the
fault-tolerant loop, against the JAX package on the CPU.

Two train steps of AdamW and of Adafactor from the same params and batches
in both packages, on a config whose segments repeat (gemma2-9b SMOKE: R =
2) and on zamba2-2.7b SMOKE: the params and the optimizer state after them
(the JAX state through ``train_state_from_numpy``).  Adafactor factors and
clips each leaf that the JAX package stacks on a segment's repeat axis as
one leaf, which these steps pin.  Then ``grad_accum=2``, and the
reference's ``tests/test_training_ft.py`` cases on the port.
"""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import ModelConfig as JModelConfig
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train as jtrain
from repro_torch.configs.registry import get_config
from repro_torch.models import ModelConfig, stacked_leaves
from repro_torch.tree import named_leaves
from repro_torch.training import (CheckpointManager, DataConfig,
                                  FaultTolerantLoop, ShardedBatcher,
                                  StepMonitor, TrainState,
                                  clip_by_global_norm, clone_state,
                                  elastic_reshard, get_optimizer,
                                  init_train_state, make_train_step,
                                  synthetic_batch, train_state_from_numpy)

torch.set_num_threads(1)

LOSS_RTOL = 1e-5                      # tests/test_training_ft.py:51
LEAF_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_training_ft.py:53
# tests/test_training_ft.py:18, in both packages
JCFG = JModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                    n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                    dtype="float32", q_chunk=16)
CFG = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                  dtype="float32", q_chunk=16)
# lr large enough, from the first step, that a wrongly grouped Adafactor
# leaf moves its params visibly
OPT_KW = {"adamw": dict(lr=1e-2), "adafactor": dict(lr=1e-2,
                                                    warmup_steps=1)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(cfg, dcfg):
    return ShardedBatcher(cfg, dcfg, device="cpu")


def _jbatch(cfg, dcfg, step):
    return {k: jnp.asarray(v) for k, v in
            jdata.synthetic_batch(cfg, dcfg, step).items()}


def _jax_state(jcfg, name):
    opt = jopt.get_optimizer(name, **OPT_KW[name])
    return opt, jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, opt)


def _flat(tree):
    """name (as the checkpoint names it) → numpy (f32 for bf16) of every
    tensor of a port tree."""
    return {n: (t.float() if t.dtype == torch.bfloat16 else t).numpy()
            for n, t in named_leaves(tree)}


def _assert_states_close(got: TrainState, want: TrainState):
    """Params at the leaf tolerances; the moments (squares of gradients for
    nu) at rtol 2e-4 and 2e-5 of each leaf's largest magnitude."""
    a, b = _flat(got), _flat(want)
    assert a.keys() == b.keys()
    for n in b:
        if n.startswith("params/"):
            np.testing.assert_allclose(a[n], b[n], err_msg=n, **LEAF_TOL)
        else:
            scale = float(np.abs(b[n]).max()) if b[n].size else 0.0
            np.testing.assert_allclose(a[n], b[n], rtol=2e-4,
                                       atol=2e-5 * scale, err_msg=n)


# ====================================================== two train steps
@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-2.7b"])
@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_two_steps_match_jax(opt_name, arch):
    jcfg, pcfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    assert any(seg.repeat > 1 for seg in pcfg.layout())
    dcfg = jdata.DataConfig(batch=2, seq_len=32)
    jo, jstate = _jax_state(jcfg, opt_name)
    state = train_state_from_numpy(_np(jstate), pcfg, device="cpu")
    jstep = jax.jit(jtrain.make_train_step(jcfg, jo))
    step = make_train_step(pcfg, get_optimizer(opt_name, **OPT_KW[opt_name]))
    batches = _batches(pcfg, DataConfig(batch=2, seq_len=32))
    for i in range(2):
        jstate, jm = jstep(jstate, _jbatch(jcfg, dcfg, i))
        state, m = step(state, next(batches))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-4)
        assert int(m["step"]) == int(jm["step"]) == i + 1
    _assert_states_close(state, train_state_from_numpy(_np(jstate), pcfg,
                                                       device="cpu"))


def test_adafactor_groups_the_stacked_leaves():
    """A per-layer norm scale (d,) is one factored (R, d) leaf: row (R,),
    col (d,); a per-layer matrix (a, b) one (R, a, b) leaf."""
    cfg = get_config("gemma2-9b", smoke=True)
    state = init_train_state(cfg, get_optimizer("adafactor"),
                             torch.Generator().manual_seed(0), device="cpu")
    nu = state.opt_state.nu
    R, d = cfg.layout()[0].repeat, cfg.d_model
    norm = nu["segments/0/0/norm_attn/scale"]
    assert norm["row"].shape == (R,) and norm["col"].shape == (d,)
    wq = nu["segments/0/1/attn/wq"]
    assert wq["row"].shape == (R, d, cfg.n_heads)
    assert wq["col"].shape == (R, d, cfg.head_dim)
    assert nu["final_norm/scale"].keys() == {"full"}
    assert set(nu) == set(stacked_leaves(state.params, cfg))


def _jax_path(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                    for k in path)


@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-2.7b",
                                  "deepseek-moe-16b", "musicgen-large"])
def test_stacked_leaves_are_the_jax_leaves_in_jax_order(arch):
    """``stacked_leaves`` over the port's params gives the JAX params'
    leaves: the same names (JAX paths), in JAX's flatten order, each the
    stacked leaf's values."""
    from repro.models import init_params as jinit_params
    from repro_torch.models import params_from_numpy

    jparams = jax.tree.map(np.asarray, jinit_params(
        jax.random.PRNGKey(0), jget_config(arch, smoke=True)))
    want = [(_jax_path(p), a) for p, a in
            jax.tree_util.tree_flatten_with_path(jparams)[0]]
    cfg = get_config(arch, smoke=True)
    got = stacked_leaves(params_from_numpy(jparams, cfg, "cpu"), cfg)
    assert list(got) == [n for n, _ in want]
    assert [n for n, _ in named_leaves(jparams)] == [n for n, _ in want]
    for n, a in want:
        leaf = got[n]
        t = torch.stack(leaf) if isinstance(leaf, tuple) else leaf
        assert tuple(t.shape) == a.shape, n
        assert np.array_equal(_flat({"t": t})["t"], a.astype(np.float32)), n


# =========================================================== grad accum
def test_grad_accum_matches_full_batch_and_jax():
    """grad_accum=2 equals one full-batch step (same tokens), and JAX's
    grad_accum=2 step."""
    opt = get_optimizer("adamw", lr=1e-2)
    jo, js0 = _jax_state(JCFG, "adamw")
    s0 = train_state_from_numpy(_np(js0), CFG, device="cpu")
    b = next(_batches(CFG, DataConfig(batch=4, seq_len=16)))
    s1, m1 = make_train_step(CFG, opt)(clone_state(s0), b)
    s2, m2 = make_train_step(CFG, opt, grad_accum=2)(clone_state(s0), b)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for (n, a), c in zip(_flat(s1.params).items(),
                         _flat(s2.params).values()):
        np.testing.assert_allclose(a, c, err_msg=n, **LEAF_TOL)
    js2, jm2 = jax.jit(jtrain.make_train_step(JCFG, jo, grad_accum=2))(
        js0, _jbatch(JCFG, jdata.DataConfig(batch=4, seq_len=16), 0))
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]),
                               rtol=LOSS_RTOL)
    _assert_states_close(s2, train_state_from_numpy(_np(js2), CFG,
                                                    device="cpu"))


# ============================ the reference's test_training_ft.py cases
@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_optimizer_descends(opt_name):
    opt = get_optimizer(opt_name, lr=1e-2)
    state = init_train_state(CFG, opt, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(CFG, opt)
    it = _batches(CFG, DataConfig(batch=4, seq_len=16))
    losses = []
    for _ in range(6):
        state, metrics = step(state, next(it))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 3.0), "b": [torch.full((4,), 4.0)]}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert np.isclose(float(norm), 10.0)
    total = np.sqrt(float((clipped["a"] ** 2).sum()
                          + (clipped["b"][0] ** 2).sum()))
    assert np.isclose(total, 1.0, rtol=1e-5)
    bf, _ = clip_by_global_norm({"w": torch.full((3,), 2.0,
                                                 dtype=torch.bfloat16)}, 1.0)
    assert bf["w"].dtype == torch.bfloat16


def test_checkpoint_restart_resumes(tmp_path):
    opt = get_optimizer("adamw", lr=1e-2)
    gen = lambda: torch.Generator().manual_seed(0)
    state = init_train_state(CFG, opt, gen(), device="cpu")
    step = make_train_step(CFG, opt)
    path = os.path.join(tmp_path, "ckpt.log")
    ck = CheckpointManager(path)
    loop = FaultTolerantLoop(step, state, ckpt=ck, ckpt_every=2)
    final = loop.run(_batches(CFG, DataConfig(batch=4, seq_len=16)), 5)
    ck.close()
    # crash + restart: resumes from the stable checkpoint at step 5
    ck2 = CheckpointManager(path)
    fresh = init_train_state(CFG, opt, gen(), device="cpu")
    loop2 = FaultTolerantLoop(step, fresh, ckpt=ck2, ckpt_every=2)
    assert loop2.step == 5
    assert int(loop2.state.opt_state.step) == 5
    a, b = _flat(loop2.state), _flat(final)
    assert a.keys() == b.keys()
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)
    ck2.close()


def test_checkpoint_time_travel(tmp_path):
    ck = CheckpointManager(os.path.join(tmp_path, "c.log"))
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    ck.save(1, tree)
    t1 = ck.log.latest("/ckpt/__meta__").timestamp_ns
    ck.save(2, {"w": torch.arange(4, dtype=torch.float32) * 10})
    step, restored = ck.restore(tree, at_time_ns=t1)
    assert step == 1
    np.testing.assert_array_equal(restored["w"].numpy(),
                                  np.arange(4, dtype=np.float32))
    assert ck.latest_step() == 2
    ck.close()


def test_checkpoint_round_trips_every_leaf_bit_for_bit(tmp_path):
    """f32, bf16, fp8 and int32 leaves (bf16 / fp8 written as raw bits
    under the JAX package's dtype names) in dicts, lists and NamedTuples."""
    rng = torch.Generator().manual_seed(3)
    f = torch.randn((5, 7), generator=rng)
    tree = TrainState(
        {"f32": f, "bf16": [f.bfloat16(), (f * 1e-3).bfloat16()],
         "fp8": (f * 4).to(torch.float8_e4m3fn)},
        {"i32": torch.arange(-3, 9, dtype=torch.int32).view(3, 4),
         "scalar": torch.tensor(7, dtype=torch.int32)})
    ck = CheckpointManager(os.path.join(tmp_path, "c.log"))
    ck.save(4, tree)
    meta = ck.log.latest("/ckpt/__meta__").payload.decode()
    assert '"dtype": "bfloat16"' in meta and '"float8_e4m3fn"' in meta
    # the bf16 payload reads back as ml_dtypes bfloat16, as JAX's would
    raw = ck.log.latest("/ckpt/params/bf16/0").payload
    np.testing.assert_array_equal(
        np.frombuffer(raw, dtype=ml_dtypes.bfloat16).astype(np.float32),
        f.bfloat16().float().numpy().ravel())
    ck.close()
    ck2 = CheckpointManager(os.path.join(tmp_path, "c.log"))
    like = TrainState({"f32": torch.zeros(5, 7),
                       "bf16": [torch.zeros(5, 7, dtype=torch.bfloat16)] * 2,
                       "fp8": torch.zeros(5, 7, dtype=torch.float8_e4m3fn)},
                      {"i32": torch.zeros(3, 4, dtype=torch.int32),
                       "scalar": torch.zeros((), dtype=torch.int32)})
    step, got = ck2.restore(like)
    assert step == 4 and isinstance(got, TrainState)
    pairs = [(got.params["f32"], f), (got.params["fp8"], tree.params["fp8"]),
             (got.opt_state["i32"], tree.opt_state["i32"]),
             (got.opt_state["scalar"], tree.opt_state["scalar"])]
    pairs += list(zip(got.params["bf16"], tree.params["bf16"]))
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
            a.element_size()]
        assert torch.equal(a.view(bits), b.view(bits))
    ck2.close()


def test_checkpoint_round_trips_bf16_without_ml_dtypes(tmp_path):
    """On the card no ml_dtypes is loaded, so numpy has no "bfloat16":
    save and restore a bf16 and an fp8 leaf in a process that imports
    only torch and the port."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys, torch\n"
        "from repro_torch.training import CheckpointManager\n"
        "assert 'ml_dtypes' not in sys.modules\n"
        "t = {'b': torch.randn(3, 5).bfloat16(),\n"
        "     'f': (torch.randn(4) * 8).to(torch.float8_e4m3fn)}\n"
        f"ck = CheckpointManager({str(tmp_path / 'c.log')!r})\n"
        "ck.save(1, t)\n"
        "step, got = ck.restore({k: torch.zeros_like(v) "
        "for k, v in t.items()})\n"
        "assert step == 1\n"
        "assert torch.equal(got['b'].view(torch.int16), "
        "t['b'].view(torch.int16))\n"
        "assert torch.equal(got['f'].view(torch.uint8), "
        "t['f'].view(torch.uint8))\n"
        "ck.close()\n")
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_straggler_monitor():
    m = StepMonitor(threshold=2.0)
    for i in range(10):
        m.observe(i, 0.1)
    assert m.observe(10, 0.5)       # 5× median → straggler
    assert not m.observe(11, 0.12)
    assert m.stragglers == [10]


def test_loop_calls_the_straggler_callback(tmp_path):
    opt = get_optimizer("adamw", lr=1e-2)
    state = init_train_state(CFG, opt, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(CFG, opt)
    calls, seen = [], []
    mon = StepMonitor(threshold=2.0)
    for i in range(8):
        mon.observe(-1, 1e3)        # a median no real step comes near
    mon.threshold = 1e-9            # every step is now a straggler
    ck = CheckpointManager(os.path.join(tmp_path, "s.log"))
    loop = FaultTolerantLoop(step, state, ckpt=ck, ckpt_every=100,
                             monitor=mon, on_straggler=calls.append)
    loop.run(_batches(CFG, DataConfig(batch=2, seq_len=8)), 2,
             metrics_cb=lambda s, m, dt: seen.append(s))
    assert calls == [1, 2] and seen == [1, 2]
    assert ck.latest_step() == 2
    ck.close()


def test_mesh_placement_raises_naming_p11():
    with pytest.raises(NotImplementedError, match="P11"):
        elastic_reshard({"w": torch.zeros(2)}, None, None)
    with pytest.raises(NotImplementedError, match="P11"):
        ShardedBatcher(CFG, DataConfig(batch=2, seq_len=8),
                       sharding=object(), device="cpu")


def test_batcher_places_the_reference_batches():
    it = ShardedBatcher(CFG, DataConfig(batch=2, seq_len=8, seed=3),
                        device="cpu")
    for step in range(2):
        got = next(it)
        want = synthetic_batch(CFG, DataConfig(batch=2, seq_len=8, seed=3),
                               step)
        for k in want:
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), want[k])
