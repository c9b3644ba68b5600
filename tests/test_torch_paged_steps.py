"""Port parity: the phase-separated paged steps ``paged_prefill`` and
``paged_decode_step`` against the JAX package's, against the port's own
``paged_mixed_step`` (as ``tests/test_mixed_tick.py:58`` holds the JAX
one), and against the port's engine, on the CPU.

Both steps run K1's wrapper once a layer: a decode step through
``paged_decode_attention`` (one token a row), a prefill through
``ragged_paged_attention`` with the (B, T) tokens packed as lanes of rows
0..B-1.  On the CPU the wrapper runs its plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as J
from repro.configs.registry import get_config as jget_config
import repro_torch.models as P
from repro_torch.configs.registry import get_config
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.scheduler import Request

torch.set_num_threads(1)

_CFG = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=128, dtype="float32",
            q_chunk=16)                          # tests/test_mixed_tick.py:22
CONFIGS = {"test": (J.ModelConfig(**_CFG), P.ModelConfig(**_CFG)),
           "gemma2_smoke": (jget_config("gemma2-9b", smoke=True),
                            get_config("gemma2-9b", smoke=True))}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}        # tests/test_kernels.py
BS = 4

_jprefill = jax.jit(J.paged_prefill, static_argnames=("cfg",))
_jdecode = jax.jit(J.paged_decode_step, static_argnames=("cfg",))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    """(name, JAX cfg, port cfg, JAX params, port params), the embedding
    table scaled to N(0, 1/d) so greedy streams vary."""
    jcfg, pcfg = CONFIGS[request.param]
    jp = J.init_params(jax.random.PRNGKey(0), jcfg)
    jp["embed"]["table"] = jp["embed"]["table"] * jcfg.d_model ** -0.5
    pp = P.params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, device="cpu")
    return request.param, jcfg, pcfg, jp, pp


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(mine, theirs, tol):
    mine, theirs = np.asarray(mine, np.float32), np.asarray(theirs,
                                                            np.float32)
    scale = max(1.0, float(np.abs(theirs).max()))
    np.testing.assert_allclose(mine, theirs, atol=tol * scale, rtol=0)


@pytest.mark.parametrize("kv_dtype", sorted(TOL))
def test_paged_steps_match_jax(model, kv_dtype):
    """A batched prefill of two rows, a suffix prefill that attends to a
    reused two-block prefix through the table, then three batched greedy
    decode steps: the logits of every step match the JAX package's (its XLA
    gather + masked softmax), and at fp32 so do the pools, bit for bit."""
    name, jcfg, pcfg, jp, pp = model
    rng = np.random.default_rng(5)
    prompts = rng.integers(1, pcfg.vocab_size, (2, 10)).astype(np.int32)
    suffix = rng.integers(1, pcfg.vocab_size, (1, 4)).astype(np.int32)
    bt = np.full((3, 8), -1, np.int32)
    bt[0, :3], bt[1, :3] = [1, 2, 3], [4, 5, 6]
    bt[2, :3] = [1, 2, 7]                 # row 0's first two blocks, shared
    jpools = J.init_paged_pools(jcfg, 16, BS, kv_dtype=kv_dtype)
    ppools = P.init_paged_pools(pcfg, 16, BS, kv_dtype=kv_dtype,
                                device="cpu")
    pos = np.tile(np.arange(10, dtype=np.int32), (2, 1))
    steps = [(bt[:2], prompts, pos), (bt[2:], suffix,
                                      np.arange(8, 12, dtype=np.int32)[None])]
    last = []
    for table, toks, p in steps:
        jl, jpools = _jprefill(jp, jpools, jnp.asarray(table),
                               jnp.asarray(toks), jnp.asarray(p), cfg=jcfg)
        pl, ppools2 = P.paged_prefill(pp, ppools, _t(table), _t(toks), _t(p),
                                      pcfg)
        assert ppools2 is ppools
        _close(pl, jl, TOL[kv_dtype])
        last.append(np.asarray(jl).argmax(-1))
    toks = np.concatenate(last).astype(np.int32)
    qpos = np.asarray([[10], [10], [12]], np.int32)
    for _ in range(3):
        jl, jpools = _jdecode(jp, jpools, jnp.asarray(bt), jnp.asarray(toks),
                              jnp.asarray(qpos), cfg=jcfg)
        pl, _ = P.paged_decode_step(pp, ppools, _t(bt), _t(toks), _t(qpos),
                                    pcfg)
        _close(pl, jl, TOL[kv_dtype])
        toks = np.asarray(jl).argmax(-1).astype(np.int32)
        qpos = qpos + 1
    if kv_dtype == "float32":
        theirs = jax.tree.leaves(jax.tree.map(np.asarray, jpools))
        mine = jax.tree.leaves(P.pools_to_numpy(ppools, pcfg))
        for a, b in zip(mine, theirs):
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)


def test_paged_steps_match_the_mixed_step(model):
    """``paged_mixed_step`` fuses the phase-separated steps: a prompt
    prefilled in two ragged chunks, then decoded one packed token a tick,
    reproduces ``paged_prefill`` + ``paged_decode_step``'s logits (same pool
    layout, same tables; packing is a scheduling change)."""
    name, jcfg, pcfg, jp, pp = model
    prompt = np.arange(1, 11, dtype=np.int32)          # 10 tokens, 3 blocks
    bt1 = torch.tensor([[1, 2, 3, -1]], dtype=torch.int32)
    pools = P.init_paged_pools(pcfg, 10, BS, device="cpu")
    ref, _ = P.paged_prefill(pp, pools, bt1, _t(prompt)[None],
                             torch.arange(10, dtype=torch.int32)[None], pcfg)
    tok = int(ref[0].argmax())
    dref, _ = P.paged_decode_step(pp, pools, bt1,
                                  torch.tensor([tok], dtype=torch.int32),
                                  torch.tensor([[10]], dtype=torch.int32),
                                  pcfg)

    T = 8
    btR = torch.tensor([[1, 2, 3, -1], [-1, -1, -1, -1]], dtype=torch.int32)

    def pack(toks, poss, sidx):
        t = np.zeros(T, np.int32)
        p = np.full(T, -1, np.int32)
        r = np.full(T, -1, np.int32)
        t[:len(toks)], p[:len(poss)], r[:len(poss)] = toks, poss, 0
        return _t(t), _t(p), _t(r), torch.tensor(sidx, dtype=torch.int32)

    pools2 = P.init_paged_pools(pcfg, 10, BS, device="cpu")
    P.paged_mixed_step(pp, pools2, btR, *pack(prompt[:6], range(6), [0, 0]),
                       pcfg)
    lg = P.paged_mixed_step(pp, pools2, btR,
                            *pack(prompt[6:], range(6, 10), [3, 0]), pcfg)
    _close(lg[0], ref[0], 2e-5)
    assert int(lg[0].argmax()) == tok
    dlg = P.paged_mixed_step(pp, pools2, btR, *pack([tok], [10], [0, 0]),
                             pcfg)
    _close(dlg[0], dref[0], 2e-5)


def test_greedy_streams_equal_the_engine(model):
    """Four prompts prefilled together, then decoded together, greedily:
    the streams the engine's mixed ticks emit for the same prompts."""
    name, jcfg, pcfg, jp, pp = model
    B, S, new = 4, 11, 6
    rng = np.random.default_rng(9)
    prompts = rng.integers(1, pcfg.vocab_size, (B, S)).astype(np.int32)
    eng = ServeEngine(pcfg, pp, n_slots=B, max_len=32, block_size=BS,
                      token_budget=16, prefix_cache=False, device="cpu")
    done = {}
    eng.on_complete = lambda r: done.setdefault(r.request_id, r.tokens)
    for i in range(B):
        eng.submit(Request(request_id=f"r{i}", session_key=f"s{i}",
                           prompt=prompts[i], max_new_tokens=new))
    eng.run_until_drained()

    nb = -(-(S + new) // BS)
    bt = torch.arange(1, 1 + B * nb, dtype=torch.int32).reshape(B, nb)
    pools = P.init_paged_pools(pcfg, 1 + B * nb, BS, device="cpu")
    logits, _ = P.paged_prefill(pp, pools, bt, _t(prompts),
                                torch.arange(S, dtype=torch.int32).repeat(B, 1),
                                pcfg)
    streams = [[int(t)] for t in logits.argmax(-1)]
    for i in range(new - 1):
        toks = torch.tensor([s[-1] for s in streams], dtype=torch.int32)
        pos = torch.full((B, 1), S + i, dtype=torch.int32)
        logits, _ = P.paged_decode_step(pp, pools, bt, toks, pos, pcfg)
        for s, t in zip(streams, logits.argmax(-1)):
            s.append(int(t))
    assert streams == [done[f"r{i}"] for i in range(B)]


def test_each_step_runs_k1_once_a_layer(model, monkeypatch):
    """The attention of both steps is K1's wrapper, once a layer: a decode
    step through ``paged_decode_attention`` (row_ids = arange(B)), a
    prefill through ``ragged_paged_attention`` with row_ids = b for each of
    row b's T lanes."""
    name, jcfg, pcfg, jp, pp = model
    calls = []
    ragged = da_ops.ragged_paged_attention

    def counted(q, kp, vp, bt, rows, pos, **kw):
        calls.append((tuple(q.shape), rows.tolist(), pos.tolist()))
        return ragged(q, kp, vp, bt, rows, pos, **kw)

    monkeypatch.setattr(da_ops, "ragged_paged_attention", counted)
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pools = P.init_paged_pools(pcfg, 5, BS, device="cpu")
    P.paged_prefill(pp, pools, bt, torch.ones((2, 3), dtype=torch.int32),
                    torch.arange(3, dtype=torch.int32).repeat(2, 1), pcfg)
    assert len(calls) == pcfg.n_layers
    H, D = pcfg.n_heads, pcfg.head_dim
    assert calls[0] == ((6, H, D), [0, 0, 0, 1, 1, 1], [0, 1, 2] * 2)
    calls.clear()
    P.paged_decode_step(pp, pools, bt, torch.ones(2, dtype=torch.int32),
                        torch.full((2, 1), 3, dtype=torch.int32), pcfg)
    assert len(calls) == pcfg.n_layers
    assert calls[0] == ((2, H, D), [0, 1], [3, 3])
