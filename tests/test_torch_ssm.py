"""Port parity: the SSM and hybrid configs (mamba2-1.3b, zamba2-2.7b) and the
dense serving path of the PyTorch port against the JAX package, on the CPU.

Both packages get the same params (a JAX ``init_params`` tree carried across
through numpy) and the same tokens: ``forward``, ``prefill`` and
``decode_step`` give logits within 1e-4 at f32 and equal caches leaf by leaf
(``caches_to_numpy`` / ``caches_from_numpy`` carry them across), and the
dense ``ServeEngine`` gives the JAX engine's greedy streams and counters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as J
from repro.configs.registry import get_config as jget_config
from repro.serving.engine import ServeEngine as JEngine
from repro.serving.scheduler import Request as JRequest
import repro_torch.models as P
from repro_torch.configs.registry import get_config
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.scheduler import Request

torch.set_num_threads(1)

ARCHS = ["mamba2-1.3b", "zamba2-2.7b"]
TOL = dict(atol=1e-4, rtol=1e-4)
_jforward = jax.jit(J.forward, static_argnames=("cfg", "mode"))
_jprefill = jax.jit(J.prefill, static_argnames=("cfg", "max_len"))
_jdecode = jax.jit(J.decode_step, static_argnames=("cfg",))


def _params(arch):
    """SMOKE configs of both packages and their params: the JAX tree (with
    N(0, 1/d) embedding rows, so greedy streams do not echo the prompt)
    and the port's copy of it."""
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = J.init_params(jax.random.PRNGKey(0), jcfg)
    jp["embed"]["table"] = jp["embed"]["table"] * jcfg.d_model ** -0.5
    pp = P.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, pp


def _assert_trees_close(want, got, **tol):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_layout_and_param_count_match_reference(arch, smoke):
    """Fields, segments and parameter count equal the JAX package's; the
    flat layer order puts zamba2's shared attention after every six mamba
    layers."""
    ours, ref = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    segs = lambda cfg: [(s.repeat, [dataclasses.astuple(p) for p in s.pattern])
                        for s in cfg.layout()]
    assert segs(ours) == segs(ref)
    assert ours.param_count() == ref.param_count()
    kinds = [s.kind for s in P.layer_specs(ours)]
    every = ours.shared_attn_every
    if every:
        assert kinds == (["mamba"] * every + ["shared_attn"]) * (
            ours.n_layers // every)
    else:
        assert kinds == ["mamba"] * ours.n_layers
    if smoke:
        own = P.init_params(ours, torch.Generator().manual_seed(0),
                            device="cpu")
        assert sum(t.numel() for t in _leaves(own)) == ours.param_count()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_jax(arch):
    """20 tokens cross the SMOKE chunk of 8 (K3's plain version over three
    chunks): ``forward`` logits, ``prefill`` over 19 tokens (last logits
    and every cache leaf), then ``decode_step`` on token 20 from the JAX
    caches carried across, whose logits also equal ``forward``'s last."""
    jcfg, cfg, jp, pp = _params(arch)
    rng = np.random.default_rng(3)
    B, S, max_len = 2, 20, 32
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    want, _ = _jforward(jp, jnp.asarray(toks), jnp.asarray(pos), cfg=jcfg,
                        mode="score")
    got, aux = P.forward(pp, torch.from_numpy(toks), torch.from_numpy(pos),
                         cfg)
    assert got.shape == (B, S, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    jl, jc = _jprefill(jp, jnp.asarray(toks[:, :-1]), jnp.asarray(pos[:, :-1]),
                       cfg=jcfg, max_len=max_len)
    pl, pc = P.prefill(pp, torch.from_numpy(toks[:, :-1]),
                       torch.from_numpy(pos[:, :-1]), cfg, max_len=max_len)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    _assert_trees_close(jc, P.caches_to_numpy(pc, cfg), **TOL)

    carried = P.caches_from_numpy(jax.tree.map(np.asarray, jc), cfg,
                                  device="cpu")
    jd, jc2 = _jdecode(jp, jc, jnp.asarray(toks[:, -1]),
                       jnp.asarray(pos[:, -1:]), cfg=jcfg)
    pd, pc2 = P.decode_step(pp, carried, torch.from_numpy(toks[:, -1]),
                            torch.from_numpy(pos[:, -1:]), cfg)
    assert pc2 is carried                        # updated in place
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_allclose(pd.numpy(), got[:, -1].numpy(), **TOL)
    _assert_trees_close(jc2, P.caches_to_numpy(pc2, cfg), **TOL)


def _serve(engine_cls, request_cls, cfg, params, prompts, max_new, **kw):
    eng = engine_cls(cfg, params, n_slots=3, max_len=40, paged=False, **kw)
    done = []
    eng.on_complete = done.append
    for i, p in enumerate(prompts):
        eng.submit(request_cls(request_id=f"r{i}", session_key=f"s{i}",
                               prompt=p, max_new_tokens=max_new[i]))
    eng.run_until_drained()
    s = eng.stats
    assert s.host_syncs == s.decode_ticks + s.prefill_batches
    return ({r.request_id: (list(r.tokens), r.error) for r in done},
            s.prefill_batches, s.decode_ticks, s.host_syncs, s.ticks,
            s.tokens_out, s.prefill_tokens)


@pytest.mark.parametrize("arch", ARCHS + ["gemma2-9b"])
def test_dense_engine_streams_and_counters_match_jax(arch):
    """Eight requests on three slots: equal-length prompts batched into one
    prefill, a prompt longer than gemma2 SMOKE's 8-slot ring, a 2-token
    prompt (shorter than the conv window: its conv state fills the slot's
    leading rows, as in the JAX package, F4), one finishing at its first
    token, one prompt over max_len (rejected).  Greedy streams, errors and
    every counter equal the JAX engine's."""
    jcfg, cfg, jp, pp = _params(arch)
    rng = np.random.default_rng(4)
    lens = [11, 11, 11, 5, 23, 11, 2, 41]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    max_new = [5, 5, 1, 6, 4, 5, 4, 2]
    want = _serve(JEngine, JRequest, jcfg, jp, prompts, max_new)
    got = _serve(ServeEngine, Request, cfg, pp, prompts, max_new,
                 device="cpu")
    assert got == want
    assert got[1] >= 3 and "max_len" in got[0]["r7"][1]


def test_dense_engine_rejects_what_jax_rejects():
    """Construction-time errors of a dense engine: a quantized kv_dtype,
    speculative decoding, preemption, a mesh, and paging a config whose
    layers carry SSM state."""
    jcfg, cfg, jp, pp = _params("mamba2-1.3b")
    for kw in (dict(kv_dtype="int8"), dict(spec_k=2), dict(preempt=True),
               dict(mesh=object()), dict(paged=True)):
        dense = {} if "paged" in kw else dict(paged=False)
        with pytest.raises(ValueError) as jerr:
            JEngine(jcfg, jp, max_len=16, **dense, **kw)
        with pytest.raises(ValueError) as perr:
            ServeEngine(cfg, pp, max_len=16, device="cpu", **dense, **kw)
        assert str(perr.value) == str(jerr.value)
