"""Port parity: the embeds configs (musicgen-large, phi-3-vision-4.2b), whose
stack takes a frontend's (B, S, d) embeddings instead of token ids, against
the JAX package on the CPU.

Both packages get the same params (a JAX ``init_params`` tree carried
across through numpy) and the same N(0, 1) embeddings made with numpy from
a seed, at f32 on the SMOKE configs: ``forward`` (score and train modes),
``prefill`` and ``decode_step`` with (B, 1, d) inputs agree within the JAX
suite's f32 tolerance (``tests/test_kernels.py``), against the JAX XLA path
and against its Pallas kernels in interpret mode (K2 in ``forward`` and
``prefill``, K4 in ``decode_step``); the dense ``ServeEngine`` and a
one-replica ``ServeCluster`` answer one-token embeds requests as the JAX
package's do.  ROADMAP F12: the JAX engine crashes in its decode tick on an
embeds request that asks for more than one token; the port rejects such a
request through the completion path and keeps serving.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as J
from repro.configs.registry import get_config as jget_config
from repro.serving.cluster import ServeCluster as JCluster
from repro.serving.engine import ServeEngine as JEngine
from repro.serving.scheduler import Request as JRequest
import repro_torch.models as P
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.serving.cluster import ServeCluster
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.scheduler import Request

torch.set_num_threads(1)

ARCHS = ["musicgen-large", "phi-3-vision-4.2b"]
BACKENDS = ["xla", "pallas_interpret"]
TOL = dict(atol=2e-5, rtol=2e-5)            # tests/test_kernels.py, f32
_jforward = jax.jit(J.forward, static_argnames=("cfg", "mode"))
_jprefill = jax.jit(J.prefill, static_argnames=("cfg", "max_len"))
_jdecode = jax.jit(J.decode_step, static_argnames=("cfg",))


def _params(arch):
    """SMOKE configs of both packages and their params: the JAX tree and
    the port's copy of it."""
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = J.init_params(jax.random.PRNGKey(0), jcfg)
    pp = P.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, pp


def _embeds(shape, seed):
    """N(0, 1) frontend embeddings, f32."""
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _positions(B, S):
    return np.tile(np.arange(S, dtype=np.int32), (B, 1))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _assert_trees_close(want, got, **tol):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **tol,
                                   err_msg=jax.tree_util.keystr(path))


# ================================================================ configs
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_params_match_reference(arch, smoke):
    """Fields, segments and parameter count equal the JAX package's; the
    port's own params keep the reference's tree: the embedding table
    always (musicgen's head, phi-3-vision's unused table) and a head only
    when untied; and the embeds configs cannot page, as in the reference."""
    ours, ref = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    assert arch in ARCH_IDS
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert [(s.repeat, [dataclasses.astuple(p) for p in s.pattern])
            for s in ours.layout()] == \
        [(s.repeat, [dataclasses.astuple(p) for p in s.pattern])
         for s in ref.layout()]
    assert ours.param_count() == ref.param_count()
    assert ours.input_mode == "embeds"
    assert not P.supports_paged(ours) and not J.supports_paged(ref)
    if smoke:
        own = P.init_params(ours, torch.Generator().manual_seed(0),
                            device="cpu")
        jp = J.init_params(jax.random.PRNGKey(0), ref)
        assert set(own) == set(jp) - {"segments"} | {"layers"}
        assert ("head" in own) == (not ours.tie_embeddings)
        assert own["embed"]["table"].shape == (ours.vocab_size,
                                               ours.d_model)
        assert sum(t.numel() for t in _leaves(own)) == ours.param_count()
        with pytest.raises(ValueError, match="paged"):
            P.init_paged_pools(ours, 4, 4, device="cpu")


# ===================================================== forward / prefill
@pytest.mark.parametrize("mode", ["score", "train"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, backend, mode):
    """(B, S, d) embeddings through ``forward``: 24 positions cross the
    SMOKE configs' q_chunk of 16."""
    jcfg, cfg, jp, pp = _params(arch)
    x, pos = _embeds((2, 24, cfg.d_model), 1), _positions(2, 24)
    want, jaux = _jforward(jp, jnp.asarray(x), jnp.asarray(pos),
                           cfg=jcfg.replace(attn_backend=backend), mode=mode)
    got, aux = P.forward(pp, torch.from_numpy(x), torch.from_numpy(pos), cfg,
                         mode=mode)
    assert got.dtype == torch.float32
    assert got.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, backend):
    """``prefill`` over 19 embeddings (last logits and every cache leaf),
    then ``decode_step`` on a (B, 1, d) embedding from the JAX caches
    carried across; its logits also equal ``forward``'s last over all 20."""
    jcfg, cfg, jp, pp = _params(arch)
    jcfg = jcfg.replace(attn_backend=backend)
    B, S, max_len = 2, 20, 32
    x, pos = _embeds((B, S, cfg.d_model), 2), _positions(B, S)
    jl, jc = _jprefill(jp, jnp.asarray(x[:, :-1]), jnp.asarray(pos[:, :-1]),
                       cfg=jcfg, max_len=max_len)
    pl, pc = P.prefill(pp, torch.from_numpy(x[:, :-1]),
                       torch.from_numpy(pos[:, :-1]), cfg, max_len=max_len)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    _assert_trees_close(jc, P.caches_to_numpy(pc, cfg), **TOL)

    carried = P.caches_from_numpy(jax.tree.map(np.asarray, jc), cfg,
                                  device="cpu")
    jd, jc2 = _jdecode(jp, jc, jnp.asarray(x[:, -1:]),
                       jnp.asarray(pos[:, -1:]), cfg=jcfg)
    pd, pc2 = P.decode_step(pp, carried, torch.from_numpy(x[:, -1:]),
                            torch.from_numpy(pos[:, -1:]), cfg)
    assert pc2 is carried                        # updated in place
    assert pd.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), **TOL)
    _assert_trees_close(jc2, P.caches_to_numpy(pc2, cfg), **TOL)
    whole, _ = P.forward(pp, torch.from_numpy(x), torch.from_numpy(pos), cfg)
    np.testing.assert_allclose(pd.numpy(), whole[:, -1].numpy(), **TOL)


# ========================================================== serving
LENS = [11, 11, 11, 5, 23, 11, 41]          # 41 > max_len: rejected


def _prompts(cfg):
    rng = np.random.default_rng(4)
    return [rng.standard_normal((n, cfg.d_model)).astype(np.float32)
            for n in LENS]


def _serve(engine_cls, request_cls, cfg, params, prompts, **kw):
    eng = engine_cls(cfg, params, n_slots=3, max_len=40, **kw)
    assert not eng.paged                    # embeds configs serve dense
    done = []
    eng.on_complete = done.append
    for i, p in enumerate(prompts):
        eng.submit(request_cls(request_id=f"r{i}", session_key=f"s{i}",
                               prompt=p, max_new_tokens=1))
    eng.run_until_drained()
    s = eng.stats
    assert s.host_syncs == s.decode_ticks + s.prefill_batches
    return ({r.request_id: (list(r.tokens), r.error) for r in done},
            {r.request_id: r.scores + r.entropies for r in done},
            (s.prefill_batches, s.decode_ticks, s.host_syncs, s.ticks,
             s.tokens_out, s.prefill_tokens, s.prompt_tokens))


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_engine_answers_one_token_requests_as_jax(arch):
    """Seven (S, d) prompts on three slots, one token each: the three
    equal-length heads share one batched prefill, one prompt over max_len
    is rejected; first tokens, errors, scores (log p and entropy) and
    every counter equal the JAX engine's."""
    jcfg, cfg, jp, pp = _params(arch)
    prompts = _prompts(cfg)
    want = _serve(JEngine, JRequest, jcfg, jp, prompts)
    got = _serve(ServeEngine, Request, cfg, pp, prompts, device="cpu")
    assert got[0] == want[0]
    assert got[2] == want[2]
    for rid, scores in want[1].items():
        np.testing.assert_allclose(got[1][rid], scores, **TOL)
    assert "max_len" in got[0]["r6"][1]
    assert got[2][0] < len(LENS) - 1 and got[2][1] == 0   # batched, no decode


@pytest.mark.parametrize("arch", ARCHS)
def test_one_replica_cluster_answers_as_jax(arch):
    """A one-replica ``ServeCluster`` of each package serves the same
    one-token embeds requests through its store hop: the same answers."""
    jcfg, cfg, jp, pp = _params(arch)
    prompts = _prompts(cfg)[:-1]
    answers = {}
    for name, cls, c, p, kw in (("jax", JCluster, jcfg, jp, {}),
                                ("port", ServeCluster, cfg, pp,
                                 {"device": "cpu"})):
        with cls(c, p, n_replicas=1, n_slots=3, max_len=40, **kw) as cl:
            for i, x in enumerate(prompts):
                cl.submit(f"s{i}", f"r{i}", x, max_new_tokens=1)
            cl.run_until_drained(timeout_s=60.0)
            answers[name] = {f"r{i}": cl.result(f"r{i}").tolist()
                             for i in range(len(prompts))}
            assert cl.stats()["completed"] == len(prompts)
    assert answers["port"] == answers["jax"]
    assert all(len(t) == 1 for t in answers["port"].values())


@pytest.mark.parametrize("arch", ARCHS)
def test_f12_multi_token_embeds_request(arch):
    """ROADMAP F12: the JAX engine's dense decode tick feeds the sampled
    (B,) token ids back as the next input, which an embeds model casts to
    floats and uses as the hidden state: it raises mid-tick.  The port
    rejects such a request through the completion path (``req.error``
    names F12, ``on_complete`` fires, nothing is enqueued) and serves the
    next request."""
    jcfg, cfg, jp, pp = _params(arch)
    x = _embeds((9, cfg.d_model), 5)
    jeng = JEngine(jcfg, jp, n_slots=2, max_len=32)
    jeng.submit(JRequest(request_id="a", session_key="a", prompt=x,
                         max_new_tokens=4))
    with pytest.raises(TypeError):
        jeng.run_until_drained()

    eng = ServeEngine(cfg, pp, n_slots=2, max_len=32, device="cpu")
    done = []
    eng.on_complete = done.append
    bad = Request(request_id="a", session_key="a", prompt=x,
                  max_new_tokens=4)
    eng.submit(bad)
    assert done == [bad] and "F12" in bad.error and bad.tokens == []
    assert eng.idle() and eng.stats.ticks == 0
    good = Request(request_id="b", session_key="b", prompt=x,
                   max_new_tokens=1)
    eng.submit(good)
    eng.run_until_drained()
    assert done == [bad, good] and good.error is None
    assert len(good.tokens) == 1
    want, _ = _jprefill(jp, jnp.asarray(x[None]),
                        jnp.asarray(_positions(1, 9)), cfg=jcfg, max_len=32)
    assert good.tokens[0] == int(np.argmax(np.asarray(want)[0]))
