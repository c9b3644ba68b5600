"""Port parity of the MoE family: the ``moe`` layer, the converted params,
``forward``, the dense and paged steps and the paged ``ServeEngine`` of
deepseek-moe-16b and llama4-maverick-400b-a17b (SMOKE) against the JAX
package, on the CPU.

The same params (a JAX tree carried across through numpy) and the same
inputs go through both packages.  The MoE layer is plain XLA in the JAX
package and plain torch in the port; attention runs the JAX XLA path and
the port's plain kernel versions (CPU tensors).  Tolerances: the layer
within 1e-5 of the output's scale at fp32 and 2e-2 at bf16 (the JAX
suite's, ``tests/test_kernels.py``); logits within 1e-4.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.models as J
from repro.configs.registry import get_config as jget_config
from repro.models import moe as jmoe
from repro.serving import scheduler as jsched
from repro.serving.engine import ServeEngine as JEngine
import repro_torch.models as P
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.models.lm import _to_torch
from repro_torch.models.mlp import mlp
from repro_torch.serving import scheduler as psched
from repro_torch.serving.engine import ServeEngine

# the package exports the function ``moe``, which shadows the module name
pmoe = importlib.import_module("repro_torch.models.moe")

torch.set_num_threads(1)

# deepseek: top-2 of 8 with 2 shared experts, a leading dense layer;
# llama4: top-1 of 8 with one shared expert, every second layer MoE
ARCHS = ("deepseek-moe-16b", "llama4-maverick-400b-a17b")
ENGINE = dict(n_slots=4, max_len=96, block_size=4, token_budget=8)

_jforward = jax.jit(J.forward, static_argnames=("cfg", "mode"))
_jprefill = jax.jit(J.prefill, static_argnames=("cfg", "max_len"))
_jdecode = jax.jit(J.decode_step, static_argnames=("cfg",))
_jmixed = jax.jit(J.paged_mixed_step, static_argnames=("cfg",))
_jpprefill = jax.jit(J.paged_prefill, static_argnames=("cfg",))
_jpdecode = jax.jit(J.paged_decode_step, static_argnames=("cfg",))


def _configs(arch, **kw):
    return (jget_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(JAX cfg, port cfg, JAX params, port params) of a SMOKE config, the
    embedding table scaled to N(0, 1/d) so greedy streams vary."""
    jcfg, pcfg = _configs(request.param)
    jp = J.init_params(jax.random.PRNGKey(0), jcfg)
    jp["embed"]["table"] = jp["embed"]["table"] * jcfg.d_model ** -0.5
    pp = P.params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, device="cpu")
    return jcfg, pcfg, jp, pp


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(mine, theirs, tol):
    """Within ``tol`` of the reference's scale (at least 1)."""
    mine, theirs = _f32(mine), _f32(theirs)
    scale = max(1.0, float(np.abs(theirs).max()))
    np.testing.assert_allclose(mine, theirs, atol=tol * scale, rtol=0)


def _layer(jcfg, pcfg, seed=1):
    """One MoE layer's params in both packages (bf16 leaves through their
    raw bits)."""
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    conv = lambda a: _to_torch(np.asarray(a), "cpu")
    return jp, {k: ({kk: conv(vv) for kk, vv in v.items()}
                    if isinstance(v, dict) else conv(v))
                for k, v in jp.items()}


def _hidden(n, d, seed=0):
    """(1, n, d) normal hidden states sharing one offset direction, as a
    model's hidden states do: the router then favours some experts, so a
    capacity factor of 1.25 drops entries."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, n, d))
            + rng.standard_normal(d)).astype(np.float32)


# ================================================================ the layer
@pytest.mark.parametrize("n", [24, 1101])
@pytest.mark.parametrize("cf", [1.25, 16.0])
@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_jax(arch, impl, cf, n):
    """y and aux of the port's ``moe`` against the reference's at fp32, for
    both dispatches, with capacity drops (cf 1.25) and without (cf 16), in
    one group (n 24) and in two groups with a ragged tail (n 1,101: G 2,
    T 550 under the einsum dispatch)."""
    jcfg, pcfg = _configs(arch, moe_impl=impl, capacity_factor=cf)
    jp, pp = _layer(jcfg, pcfg)
    x = _hidden(n, jcfg.d_model)
    want, jaux = jmoe.moe(jp, jnp.asarray(x), cfg=jcfg)
    got, aux = pmoe.moe(pp, torch.from_numpy(x), cfg=pcfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want, 1e-5)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    plan = pmoe.dispatch_plan(pp, torch.from_numpy(x[0]), pcfg)
    dropped = int((~plan.keep).sum())
    assert (dropped > 0) == (cf < 2), dropped
    G, T = pmoe.groups(n, pcfg)
    assert (plan.groups, plan.row.shape[0]) == (G, G * T)
    assert (G, T) == ((1, n) if impl == "scatter" or n < 1024 else (2, 550))


def test_einsum_tail_gets_no_routed_output():
    """ROADMAP F10, mirrored: under the einsum dispatch the last N - G·T
    tokens get the shared experts' output only, in both packages; the
    scatter dispatch routes them."""
    jcfg, pcfg = _configs(ARCHS[0], capacity_factor=16.0)
    jp, pp = _layer(jcfg, pcfg)
    x = _hidden(1101, jcfg.d_model)
    shared = mlp(pp["shared"], torch.from_numpy(x))[0, -1]
    got = pmoe.moe(pp, torch.from_numpy(x), cfg=pcfg)[0][0]
    want = np.asarray(jmoe.moe(jp, jnp.asarray(x), cfg=jcfg)[0])[0]
    assert torch.equal(got[-1], shared)
    np.testing.assert_allclose(want[-1], shared.numpy(), atol=1e-5, rtol=0)
    assert float((got[-2] - shared).abs().max()) > 1.0   # routed: differs
    routed = pmoe.moe(pp, torch.from_numpy(x),
                      cfg=pcfg.replace(moe_impl="scatter"))[0][0, -1]
    assert float((routed - shared).abs().max()) > 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_bf16_matches_jax(arch):
    """At bf16 (f32 router) the layer agrees within 2e-2 of the output's
    scale: the combine weights are rounded to bf16 and the k products
    summed in f32, as the reference's combine einsum does."""
    jcfg, pcfg = _configs(arch, dtype="bfloat16")
    jp, pp = _layer(jcfg, pcfg)
    assert pp["router"].dtype == torch.float32
    assert pp["w_gate"].dtype == torch.bfloat16
    x = _hidden(24, jcfg.d_model, seed=3)
    want, jaux = jmoe.moe(jp, jnp.asarray(x, jnp.bfloat16), cfg=jcfg)
    got, aux = pmoe.moe(pp, torch.from_numpy(x).to(torch.bfloat16), cfg=pcfg)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want).astype(np.float32), 2e-2)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-3)


def test_moe_init_follows_the_reference_layout():
    """The port's own init: the reference's leaf names, shapes and dtypes,
    the router in f32, and the experts drawn with fan-in E (F11)."""
    jcfg, pcfg = _configs(ARCHS[0], dtype="bfloat16")
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    gen = torch.Generator().manual_seed(0)
    pp = pmoe.moe_init(gen, pcfg, "cpu")
    assert pp.keys() == jp.keys() and pp["shared"].keys() == jp["shared"].keys()
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert tuple(pp[k].shape) == jp[k].shape
        assert str(pp[k].dtype).split(".")[1] == jp[k].dtype.name
    assert pp["router"].dtype == torch.float32
    assert pp["shared"]["w_gate"].shape == (pcfg.d_model, 2 * pcfg.moe_d_ff)
    std = float(pp["w_gate"].float().std())
    assert abs(std - pcfg.n_experts ** -0.5) < 0.05 * pcfg.n_experts ** -0.5


# =================================================================== params
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_the_moe_subtree(arch, dtype):
    """``params_from_numpy`` of a JAX MoE tree: the reference's leaf names,
    shapes and dtypes (router f32) in the flat layer order, leaf counts
    equal to ``param_count()``, and ``init_params`` / ``init_paged_pools``
    build the same structure."""
    jcfg, pcfg = _configs(arch, dtype=dtype)
    jp = jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(0), jcfg))
    pp = P.params_from_numpy(jp, pcfg, device="cpu")
    specs = P.layer_specs(pcfg)
    kinds = [s.kind for s in specs]
    assert "attn_moe" in kinds and "attn_mlp" in kinds
    flat = [p for seg, seg_tree in zip(pcfg.layout(), jp["segments"])
            for r in range(seg.repeat) for p in
            [jax.tree.map(lambda a, r=r: a[r], t) for t in seg_tree]]
    for spec, mine, theirs in zip(specs, pp["layers"], flat):
        assert ("moe" in mine) == (spec.kind == "attn_moe") != ("mlp" in mine)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(theirs),
                                jax.tree.leaves(mine)):
            assert tuple(b.shape) == a.shape, path
            assert str(b.dtype).split(".")[1] == a.dtype.name, path
            np.testing.assert_array_equal(_f32(b), _f32(a))
        if spec.kind == "attn_moe":
            assert mine["moe"]["router"].dtype == torch.float32
    n_port = sum(t.numel() for t in jax.tree.leaves(pp))
    n_ref = sum(a.size for a in jax.tree.leaves(jp))
    assert n_port == n_ref == pcfg.param_count() == jcfg.param_count()
    own = P.init_params(pcfg, device="cpu")
    assert jax.tree.structure(own) == jax.tree.structure(pp)
    assert [(t.shape, t.dtype) for t in jax.tree.leaves(own)] == \
        [(t.shape, t.dtype) for t in jax.tree.leaves(pp)]
    pools = P.init_paged_pools(pcfg, 4, 4, device="cpu")
    assert len(pools) == pcfg.n_layers


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_layout_and_param_count_match_reference(arch, smoke):
    ours, ref = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert [(s.repeat, [dataclasses.astuple(p) for p in s.pattern])
            for s in ours.layout()] == \
        [(s.repeat, [dataclasses.astuple(p) for p in s.pattern])
         for s in ref.layout()]
    assert ours.param_count() == ref.param_count()
    assert arch in ARCH_IDS and P.supports_paged(ours)
    if arch == "deepseek-moe-16b" and not smoke:
        assert ours.param_count() == 16_375_728_128


# ================================================================== forward
def _tokens(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return toks, np.tile(np.arange(S, dtype=np.int32), (B, 1))


def test_forward_matches_jax_score(model):
    """Logits and the summed aux loss equal the JAX forward in score mode
    (B 2, S 24)."""
    jcfg, pcfg, jp, pp = model
    toks, pos = _tokens(pcfg.vocab_size, 2, 24, 11)
    want, jaux = _jforward(jp, jnp.asarray(toks), jnp.asarray(pos), cfg=jcfg,
                           mode="score")
    got, aux = P.forward(pp, _t(toks), _t(pos), pcfg)
    assert got.shape == (2, 24, pcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    n_moe = sum(s.kind == "attn_moe" for s in P.layer_specs(pcfg))
    assert aux.dtype == torch.float32 and float(aux) >= n_moe * (1 - 1e-3)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


# ============================================================== dense steps
@pytest.mark.parametrize("cf", [16.0, 1.25])
def test_prefill_and_decode_match_jax(model, cf):
    """``prefill`` over 19 tokens, then two ``decode_step``s, against the
    JAX pair: at capacity factor 16 (no drops: decode equals the forward,
    the reference's ``test_moe_decode_matches_forward_no_drop``) and at
    1.25."""
    jcfg, pcfg, jp, pp = model
    jcfg, pcfg = jcfg.replace(capacity_factor=cf), pcfg.replace(
        capacity_factor=cf)
    toks, pos = _tokens(pcfg.vocab_size, 2, 21, 12)
    jl, jc = _jprefill(jp, jnp.asarray(toks[:, :19]), jnp.asarray(pos[:, :19]),
                       cfg=jcfg, max_len=32)
    pl, pc = P.prefill(pp, _t(toks[:, :19]), _t(pos[:, :19]), pcfg,
                       max_len=32)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for i in (19, 20):
        jl, jc = _jdecode(jp, jc, jnp.asarray(toks[:, i]),
                          jnp.asarray(pos[:, i:i + 1]), cfg=jcfg)
        pl, pc = P.decode_step(pp, pc, _t(toks[:, i]), _t(pos[:, i:i + 1]),
                               pcfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    if cf > 2:
        full, _ = P.forward(pp, _t(toks), _t(pos), pcfg)
        np.testing.assert_allclose(pl.numpy(), full[:, -1].numpy(),
                                   atol=1e-4, rtol=1e-4)


# ============================================================== paged steps
def _ticks(vocab):
    """Two packed ticks of 24 lanes over three request rows (a chunked
    prefill, a short prompt, a row whose context tick 1 writes), the second
    with a 3-token verify row and 12 pad lanes.  Returns the block tables
    and per-tick (tokens, positions, rows, sample_idx)."""
    rng = np.random.default_rng(7)
    bt = np.asarray([[1, 2, 3, 4, 5, -1], [6, 7, -1, -1, -1, -1],
                     [8, 9, 10, -1, -1, -1]], np.int32)

    def pack(parts):
        toks, pos = np.zeros(24, np.int32), np.full(24, -1, np.int32)
        rows, sidx = np.full(24, -1, np.int32), np.zeros((3, 3), np.int32)
        n = 0
        for row, start, length in parts:
            toks[n:n + length] = rng.integers(0, vocab, length)
            pos[n:n + length] = np.arange(start, start + length)
            rows[n:n + length] = row
            sidx[row] = n + np.minimum(np.arange(3), length - 1)
            n += length
        return toks, pos, rows, sidx

    return bt, [pack([(0, 0, 10), (1, 0, 5), (2, 0, 9)]),
                pack([(0, 10, 8), (1, 5, 1), (2, 9, 3)])]


def test_paged_mixed_step_matches_jax(model):
    """Two packed ticks, pad lanes routed as the reference routes them: the
    logits of every row's verify positions, and every pool block but block
    0 (where pad lanes write in any order)."""
    jcfg, pcfg, jp, pp = model
    bt, ticks = _ticks(pcfg.vocab_size)
    jpools = J.init_paged_pools(jcfg, 12, 4)
    ppools = P.init_paged_pools(pcfg, 12, 4, device="cpu")
    for toks, pos, rows, sidx in ticks:
        want, jpools = _jmixed(jp, jpools, *map(jnp.asarray,
                                                (bt, toks, pos, rows, sidx)),
                               cfg=jcfg)
        got = P.paged_mixed_step(pp, ppools, *map(_t, (bt, toks, pos, rows,
                                                       sidx)), pcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
    for a, b in zip(jax.tree.leaves(P.pools_to_numpy(ppools, pcfg)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jpools))):
        np.testing.assert_allclose(a[:, 1:], b[:, 1:], atol=2e-5, rtol=0)


def test_paged_prefill_and_decode_match_jax(model):
    """``paged_prefill`` of two rows, a suffix prefill over a shared
    prefix, then three batched ``paged_decode_step``s."""
    jcfg, pcfg, jp, pp = model
    rng = np.random.default_rng(5)
    prompts = rng.integers(1, pcfg.vocab_size, (2, 10)).astype(np.int32)
    suffix = rng.integers(1, pcfg.vocab_size, (1, 4)).astype(np.int32)
    bt = np.full((3, 8), -1, np.int32)
    bt[0, :3], bt[1, :3], bt[2, :3] = [1, 2, 3], [4, 5, 6], [1, 2, 7]
    jpools = J.init_paged_pools(jcfg, 16, 4)
    ppools = P.init_paged_pools(pcfg, 16, 4, device="cpu")
    last = []
    for table, toks, p in ((bt[:2], prompts,
                            np.tile(np.arange(10, dtype=np.int32), (2, 1))),
                           (bt[2:], suffix,
                            np.arange(8, 12, dtype=np.int32)[None])):
        jl, jpools = _jpprefill(jp, jpools, *map(jnp.asarray, (table, toks,
                                                               p)), cfg=jcfg)
        pl, _ = P.paged_prefill(pp, ppools, _t(table), _t(toks), _t(p), pcfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        last.append(np.asarray(jl).argmax(-1))
    toks = np.concatenate(last).astype(np.int32)
    qpos = np.asarray([[10], [10], [12]], np.int32)
    for _ in range(3):
        jl, jpools = _jpdecode(jp, jpools, *map(jnp.asarray, (bt, toks, qpos)),
                               cfg=jcfg)
        pl, _ = P.paged_decode_step(pp, ppools, _t(bt), _t(toks), _t(qpos),
                                    pcfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        toks = np.asarray(jl).argmax(-1).astype(np.int32)
        qpos = qpos + 1


# =================================================================== engine
def _requests(mod, vocab):
    """``tests/test_torch_serving.py``'s four prompts: two share a 20-token
    prefix, one is longer than the token budget several times over."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 20)
    out = []
    for i, L in enumerate((20, 37, 9, 25)):
        p = rng.integers(0, vocab, L).astype(np.int32)
        if i in (1, 3):
            p = np.concatenate([shared, p]).astype(np.int32)
        out.append(mod.Request(request_id=f"r{i}", session_key=f"r{i}",
                               prompt=p, max_new_tokens=10))
    return out


def _serve(engine):
    done = []
    engine.on_complete = done.append
    for r in _requests(psched if isinstance(engine, ServeEngine) else jsched,
                       engine.cfg.vocab_size):
        engine.submit(r)
    engine.run_until_drained()
    s = engine.stats
    counters = (s.ticks, s.prefill_chunks, s.prefix_hit_tokens, s.spec_drafted,
                s.spec_accepted, s.spec_rolled_back, s.host_syncs,
                s.decode_ticks, s.tokens_out, s.prompt_tokens,
                s.prefill_tokens, s.prefix_hits)
    return {r.request_id: list(r.tokens) for r in done}, counters, s


@pytest.mark.parametrize("spec_k", [0, 2])
def test_engine_matches_jax_engine(model, spec_k):
    """The paged engine serves the MoE configs: greedy streams and counters
    equal the JAX engine's, one host sync a tick.  A token's output depends
    on its tick's other tokens through capacity, in both packages, so each
    spec_k is held against the reference's run at the same spec_k."""
    jcfg, pcfg, jp, pp = model
    jstreams, jcount, _ = _serve(JEngine(jcfg, jp, spec_k=spec_k, **ENGINE))
    pstreams, pcount, stats = _serve(ServeEngine(pcfg, pp, spec_k=spec_k,
                                                 device="cpu", **ENGINE))
    assert pstreams == jstreams
    assert pcount == jcount
    assert stats.host_syncs == stats.ticks
    assert stats.prefix_hit_tokens > 0 and stats.prefill_chunks > 8
