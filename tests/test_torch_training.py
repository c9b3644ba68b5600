"""Port parity for training: the loss and every gradient of each registered
config, and remat, against the JAX package on the CPU (K2's and K3's
autograd Functions alone: ``test_torch_train_autograd.py``).

The same params (a JAX ``init_params`` tree carried across through numpy)
and the same batches (both packages' ``synthetic_batch``, which must agree)
go through ``jax.value_and_grad(repro.training.train.make_loss_fn(cfg))``
and the port's loss and autograd.  The JAX train step differentiates its
XLA attention (``_attend_chunked``) and its pure-JAX SSD; the port's K2 and
K3 wrappers run their plain versions on CPU tensors and differentiate them
through ``torch.autograd.Function``s.  Tolerances are the reference's
(``tests/test_training_ft.py``: rtol 1e-5 on the loss; rtol 2e-4, atol 2e-5
on every leaf).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.training import data as jdata
from repro.training.train import make_loss_fn as jmake_loss_fn
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.models import forward, params_from_numpy, stacked_leaves
from repro_torch.training import data as pdata
from repro_torch.training import train as ptrain
from repro_torch.tree import named_leaves

torch.set_num_threads(1)

LOSS_RTOL = 1e-5                      # tests/test_training_ft.py:51
LEAF_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_training_ft.py:53
DCFG = dict(batch=2, seq_len=32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_grads(jcfg, jparams, batch):
    fn = jax.jit(jax.value_and_grad(jmake_loss_fn(jcfg), has_aux=True))
    (loss, metrics), grads = fn(jparams, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _port_batch(cfg, step=0, **dcfg):
    return {k: torch.from_numpy(v) for k, v in pdata.synthetic_batch(
        cfg, pdata.DataConfig(**(dcfg or DCFG)), step).items()}


def _stack(leaf):
    return (np.stack([t.detach().numpy() for t in leaf])
            if isinstance(leaf, tuple) else leaf.detach().numpy())


def _global_norm(flat: dict) -> float:
    return float(np.sqrt(sum(np.sum(np.square(a.astype(np.float64)))
                             for a in flat.values())))


# ============================================================ the data
@pytest.mark.parametrize("arch", ["gemma2-9b", "musicgen-large"])
def test_synthetic_batch_equals_the_reference(arch):
    jcfg, pcfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    for step in (0, 3):
        for host in (0, 1):
            kw = dict(batch=4, seq_len=16, seed=7, n_hosts=2, host_id=host)
            want = jdata.synthetic_batch(jcfg, jdata.DataConfig(**kw), step)
            got = pdata.synthetic_batch(pcfg, pdata.DataConfig(**kw), step)
            assert want.keys() == got.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k])


# ================================================== loss and gradients
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_every_gradient_match_jax(arch):
    """Every registered config (SMOKE, f32): loss, ce, aux, the global
    gradient norm and every gradient leaf, named by its JAX path (a stacked
    leaf's port layers stacked on the repeat axis)."""
    jcfg, pcfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    batch = jdata.synthetic_batch(jcfg, jdata.DataConfig(**DCFG), 0)
    jloss, jmetrics, jgrads = _jax_grads(jcfg, jparams, batch)

    params = params_from_numpy(_np(jparams), pcfg, device="cpu")
    (loss, metrics), grads = ptrain.value_and_grad(
        ptrain.make_loss_fn(pcfg), params, _port_batch(pcfg))
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["ce"]), jmetrics["ce"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["aux_loss"]),
                               jmetrics["aux_loss"], rtol=LOSS_RTOL,
                               atol=1e-7)
    want = dict(named_leaves(_np(jgrads)))
    got = {n: _stack(g) for n, g in stacked_leaves(grads, pcfg).items()}
    assert got.keys() == want.keys()
    for n in want:
        assert got[n].dtype == want[n].dtype, n
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **LEAF_TOL)
    np.testing.assert_allclose(_global_norm(got), _global_norm(want),
                               rtol=2e-4)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "deepseek-moe-16b"])
def test_remat_on_and_off_give_the_same_gradients(arch):
    """Remat recomputes each pattern copy in the backward (zamba2's shared
    block and embeds0 through the checkpoint; the MoE aux summed as
    without it): the same loss and gradients."""
    cfg = get_config(arch, smoke=True)
    assert cfg.remat
    params = params_from_numpy(
        _np(jinit_params(jax.random.PRNGKey(1), jget_config(arch,
                                                            smoke=True))),
        cfg, device="cpu")
    batch = _port_batch(cfg, 1)
    runs = {}
    for remat in (True, False):
        c = cfg.replace(remat=remat)
        runs[remat] = ptrain.value_and_grad(ptrain.make_loss_fn(c), params,
                                             batch)
    (l1, m1), g1 = runs[True]
    (l0, m0), g0 = runs[False]
    assert torch.equal(l1, l0) and torch.equal(m1["aux_loss"],
                                               m0["aux_loss"])
    a, b = stacked_leaves(g1, cfg), stacked_leaves(g0, cfg)
    for n in a:
        np.testing.assert_allclose(_stack(a[n]), _stack(b[n]), rtol=1e-6,
                                   atol=1e-7, err_msg=n)


def test_score_mode_is_the_train_forward_without_grad():
    cfg = get_config("zamba2-2.7b", smoke=True)
    params = params_from_numpy(_np(jinit_params(
        jax.random.PRNGKey(2), jget_config("zamba2-2.7b", smoke=True))),
        cfg, device="cpu")
    b = _port_batch(cfg)
    score, _ = forward(params, b["inputs"], b["positions"], cfg)
    with torch.no_grad():
        train, _ = forward(params, b["inputs"], b["positions"], cfg,
                           mode="train")
    assert torch.equal(score, train)
