"""Port parity: the sharded train step's head and loss split over the
vocabulary (``training.train.vocab_nll_sum``, ``models.forward(...,
split_vocab=True)``), on the CPU at SMOKE sizes.

The reference's ``cross_entropy`` is plain XLA; with ``vocab`` over
'model' GSPMD keeps the logits split and reduces only (B, S) values
across the shards.  The port does the same: each shard's softcapped
logits stay on their shard, and the NLL takes three (B, S) all-reduces
(the row max, Σ exp, the target's logit).  Tolerances: the NLL against
``nll_sum`` of the gathered logits within 2e-6 relative (loss) and 2e-5
(grads); the train steps at ``tests/test_torch_sharded_steps.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.training import optimizer as jopt
from repro.training import train as jtrain
import repro_torch.models as P
from repro_torch.configs.registry import get_config
from repro_torch.launch.costs import CostCounter
from repro_torch.launch.mesh import _make_mesh, logical_devices
from repro_torch.launch.spmd import Program
from repro_torch.models import TensorParallel, slices
from repro_torch.models.layers import softcap
from repro_torch.training import (DataConfig, ShardedBatcher, clone_state,
                                  get_optimizer, make_train_step,
                                  train_state_from_numpy)
from repro_torch.training.train import nll_sum, vocab_nll_sum
from repro_torch.tree import named_leaves

torch.set_num_threads(1)

LOSS_RTOL = 2e-6
GRAD_TOL = 2e-5
TOL = 2e-5                         # tests/test_torch_sharded_steps.py
S = 12


def _mesh(shape, device="cpu"):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    with logical_devices(int(np.prod(shape)), device):
        return _make_mesh(shape, axes)


@pytest.mark.parametrize("m", [1, 2, 4])
def test_vocab_nll_equals_nll_sum_of_the_gathered_logits(m):
    """Each shard's softcapped slice of the logits in, the NLL sum out:
    equal to ``nll_sum`` of the whole softcapped logits, with targets on
    every shard's first and last row, masked tokens, and logits large
    enough that the max shift matters; the grads of the raw logits too."""
    g = torch.Generator().manual_seed(m)
    B, T, V = 3, 9, 24
    w = V // m
    x = (torch.randn((B, T, V), generator=g) * 40.0).requires_grad_()
    targets = torch.randint(0, V, (B, T), generator=g)
    targets[0, :m] = torch.arange(m) * w               # each shard's first
    targets[1, :m] = torch.arange(1, m + 1) * w - 1     # and last row
    mask = (torch.rand((B, T), generator=g) > 0.3).float()
    mask[0, :m] = mask[1, :m] = 1.0
    want = nll_sum(softcap(x, 30.0), targets, mask)
    (gw,) = torch.autograd.grad(want, x)
    tp = TensorParallel(devices=(torch.device("cpu"),) * m,
                        vocab=tuple((s * w, (s + 1) * w) for s in range(m)))
    parts = [softcap(x[..., s * w:(s + 1) * w], 30.0) for s in range(m)]
    got = vocab_nll_sum(parts, targets, mask, tp)
    (gg,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), want.item(), rtol=LOSS_RTOL)
    np.testing.assert_allclose(gg.numpy(), gw.numpy(), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    unmasked = vocab_nll_sum([p.detach() for p in parts], targets, None, tp)
    np.testing.assert_allclose(
        unmasked.item(), nll_sum(softcap(x.detach(), 30.0), targets).item(),
        rtol=LOSS_RTOL)


def _flat(tree):
    return {n: t.float().numpy() for n, t in named_leaves(tree)}


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_sharded_train_step_with_a_split_head(shape):
    """gemma2-9b SMOKE (tied head, final softcap 30, the vocabulary over
    'model'): two sharded AdamW steps on a masked batch of 8 equal the
    one-device steps and JAX's ``make_train_step``: loss, CE, grad norm,
    step and every param and moment leaf."""
    arch = "gemma2-9b"
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    assert cfg.tie_embeddings and cfg.final_logit_softcap
    jo = jopt.get_optimizer("adamw", lr=1e-2)
    js = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, jo)
    opt = get_optimizer("adamw", lr=1e-2)
    state = train_state_from_numpy(jax.tree.map(np.asarray, js), cfg, "cpu")
    mesh = _mesh(shape)
    prog = Program(cfg, mesh, batch=8)
    assert all(tp.vocab is not None for tp in prog.tps)
    placed = prog.place_state(clone_state(state), opt.name)
    step1 = make_train_step(cfg, opt)
    stepm = make_train_step(cfg, opt, mesh=mesh)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jo))
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


class _Shapes(CostCounter):
    """A counter that keeps the shape of every tensor whose storage the
    program allocates."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def _alloc(self, t, s):
        self.shapes.append(tuple(t.shape))
        super()._alloc(t, s)


def _meta_step(monkeypatch, fn):
    """``fn()`` under a shape-keeping counter, with every collective the
    slices record kept as (kind, bytes)."""
    seen = []
    real = slices.record_collective

    def record(kind, nbytes, *args):
        seen.append((kind, nbytes))
        real(kind, nbytes, *args)

    monkeypatch.setattr(slices, "record_collective", record)
    counter = _Shapes()
    with counter:
        fn()
    return counter, seen


def test_the_split_step_on_meta_never_holds_the_whole_vocabulary(
        monkeypatch):
    """On meta, under the dry run's counter, gemma2-9b SMOKE's (2, 2)
    train step allocates no tensor whose last dim is the whole vocabulary
    and records no all-gather of the logits (its collectives are three
    (B, S) all-reduces per piece in their place); the score forward of
    the same program, whose logits are whole, does both."""
    cfg = get_config("gemma2-9b", smoke=True)
    V, B = cfg.vocab_size, 8
    prog = Program(cfg, _mesh((2, 2), "meta"), batch=B)
    opt = get_optimizer("adamw", lr=1e-2)
    state = prog.init_state(opt, prog.place_params(
        P.init_params(cfg, device="meta")))
    meta = lambda dt: torch.empty((B, S), dtype=dt, device="meta")
    batch = prog.place_batch({"inputs": meta(torch.int32),
                              "targets": meta(torch.int32),
                              "positions": meta(torch.int32),
                              "mask": meta(torch.float32)})
    step = prog.train_step(opt)
    counter, seen = _meta_step(monkeypatch, lambda: step(state, batch))
    logits_bytes = (B // 2) * S * V * 4
    assert counter.shapes and not [s for s in counter.shapes
                                   if s and s[-1] == V]
    assert ("all-gather", logits_bytes) not in seen
    assert seen.count(("all-reduce", (B // 2) * S * 4)) >= 3 * 2
    counter, seen = _meta_step(monkeypatch, lambda: prog.forward(
        state.params, batch["inputs"], batch["positions"], mode="train"))
    assert [s for s in counter.shapes if s and s[-1] == V]
    assert ("all-gather", logits_bytes) in seen
