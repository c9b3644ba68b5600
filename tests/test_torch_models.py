"""Port parity: config, layer functions, weight/pool conversion, the paged
mixed step and the full-sequence forward of the PyTorch port against the
JAX package.

The same params (a JAX ``init_params`` tree carried across through numpy)
and the same inputs go through both packages on the CPU.  The JAX side runs
its XLA attention path or its Pallas kernels in interpret mode; the port
runs the plain versions of its kernels (CPU tensors).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.models as J
from repro.configs.registry import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models.config import LayerSpec as JLayerSpec
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import Segment as JSegment
import repro_torch.models as P
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.models import layers as players
from repro_torch.models import mlp as pmlp
from repro_torch.models.config import LayerSpec, ModelConfig, Segment

torch.set_num_threads(1)

# tests/test_paged_kv.py:14, in both packages
JCFG = JModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                    n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                    dtype="float32", q_chunk=16)
PCFG = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                   n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                   dtype="float32", q_chunk=16)
CONFIGS = {"test": (JCFG, PCFG),
           "gemma2_smoke": (jget_config("gemma2-9b", smoke=True),
                            get_config("gemma2-9b", smoke=True)),
           "gemma3_smoke": (jget_config("gemma3-4b", smoke=True),
                            get_config("gemma3-4b", smoke=True)),
           "danube1_smoke": (jget_config("h2o-danube-1.8b", smoke=True),
                             get_config("h2o-danube-1.8b", smoke=True)),
           "danube3_smoke": (jget_config("h2o-danube-3-4b", smoke=True),
                             get_config("h2o-danube-3-4b", smoke=True))}
NEW_ARCHS = ("gemma3-4b", "h2o-danube-1.8b", "h2o-danube-3-4b")
KV_DTYPES = ("float32", "bfloat16", "int8", "fp8_e4m3")
LADDER = {"float32": 2e-5, "bfloat16": 2e-2, "int8": 8e-2,
          "fp8_e4m3": 2.5e-1}                 # tests/test_kernels.py:426

_jmixed = jax.jit(J.paged_mixed_step, static_argnames=("cfg",))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _params(name):
    jcfg, pcfg = CONFIGS[name]
    jp = J.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, P.params_from_numpy(_np_tree(jp), pcfg, device="cpu")


def _f32(a):
    """A pool leaf as f32 numpy: ml_dtypes arrays (JAX side) and raw-bit
    arrays (``pools_to_numpy``) alike."""
    if a.dtype == np.uint16:
        a = a.view(ml_dtypes.bfloat16)
    elif a.dtype == np.uint8:
        a = a.view(ml_dtypes.float8_e4m3fn)
    return np.asarray(a).astype(np.float32)


# =============================================================== config
@pytest.mark.parametrize("ours,ref", [(ModelConfig, JModelConfig),
                                      (LayerSpec, JLayerSpec),
                                      (Segment, JSegment)])
def test_config_dataclasses_match_reference(ours, ref):
    def sig(cls):
        return [(f.name, f.default, f.default_factory)
                for f in dataclasses.fields(cls)]
    assert sig(ours) == sig(ref)


@pytest.mark.parametrize("smoke", [False, True])
def test_gemma2_layout_and_param_count_match_reference(smoke):
    ours, ref = get_config("gemma2-9b", smoke=smoke), \
        jget_config("gemma2-9b", smoke=smoke)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert [(s.repeat, [dataclasses.astuple(p) for p in s.pattern])
            for s in ours.layout()] == \
        [(s.repeat, [dataclasses.astuple(p) for p in s.pattern])
         for s in ref.layout()]
    assert ours.param_count() == ref.param_count()
    assert ARCH_IDS == ("musicgen-large", "phi-3-vision-4.2b",
                        "llama4-maverick-400b-a17b", "deepseek-moe-16b",
                        "gemma3-4b", "gemma2-9b", "h2o-danube-1.8b",
                        "h2o-danube-3-4b", "mamba2-1.3b", "zamba2-2.7b")
    # flat layer order: copy r, pattern position i -> layer 2r + i, so the
    # window sits on the even (local) layers only
    windows = [s.window for s in P.layer_specs(ours)]
    assert windows == [ours.window, None] * (ours.n_layers // 2)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_layout_and_param_count_match_reference(arch, smoke):
    """The configs that joined with the full-sequence forward: fields,
    segments, parameter count and the flat layer order (windows and RoPE
    thetas of every layer) equal the JAX package's."""
    ours, ref = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    segs = lambda cfg: [(s.repeat, [dataclasses.astuple(p) for p in s.pattern])
                        for s in cfg.layout()]
    assert segs(ours) == segs(ref)
    assert ours.param_count() == ref.param_count()
    flat = [(s.window, s.rope_theta) for s in P.layer_specs(ours)]
    assert flat == [(p.window, p.rope_theta) for seg in ref.layout()
                    for _ in range(seg.repeat) for p in seg.pattern]
    if arch == "gemma3-4b":          # 5 local : 1 global, then 4 local
        loc, glob = (ours.window, ours.rope_theta_local), (None,
                                                           ours.rope_theta)
        full, rem = divmod(ours.n_layers, 6)
        assert flat == ([loc] * 5 + [glob]) * full + [loc] * rem
    else:                            # sliding window on every layer
        assert flat == [(ours.window, ours.rope_theta)] * ours.n_layers


# ======================================================== layer functions
def _j(x):
    return jnp.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rmsnorm_matches(dt):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32) * 0.1
    jx = _j(x).astype(dt)
    want = jlayers.rmsnorm({"scale": _j(scale)}, jx)
    got = players.rmsnorm({"scale": torch.from_numpy(scale)},
                          _t(jx.astype(jnp.float32)).to(getattr(torch, dt)))
    assert got.dtype == getattr(torch, dt)
    tol = 1e-6 if dt == "float32" else 8e-3     # one bf16 rounding
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rope_half_split_matches(dt):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, size=(7,)).astype(np.int32)
    jx = _j(x).astype(dt)
    want = jlayers.rope(jx, _j(pos), 10_000.0)
    tx = _t(jx.astype(jnp.float32)).to(getattr(torch, dt))
    got = players.rope(tx, torch.from_numpy(pos), 10_000.0)
    assert got.dtype == tx.dtype
    tol = 2e-4 if dt == "float32" else 2e-2    # f32 sin/cos at pos ~5000
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_embed_scale_rounds_sqrt_d_to_the_model_dtype():
    """gemma2's sqrt(3584) = 59.87 is applied as bf16(59.87) = 59.75, in
    both packages, and the scaled embeddings agree bit for bit."""
    d = 3584
    rng = np.random.default_rng(2)
    table = rng.normal(size=(11, d)).astype(np.float32)
    toks = np.asarray([3, 0, 10, 3], np.int32)
    jt = _j(table).astype(jnp.bfloat16)
    want = jlayers.embed_lookup({"table": jt}, _j(toks), scale=True, d=d)
    tt = torch.from_numpy(np.asarray(jt).view(np.uint16).copy()).view(
        torch.bfloat16)
    got = players.embed_lookup({"table": tt}, torch.from_numpy(toks),
                               scale=True, d=d)
    assert torch.tensor(np.sqrt(d), dtype=torch.bfloat16).item() == 59.75
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                          np.asarray(want).view(np.uint16))
    np.testing.assert_array_equal(
        got.float().numpy(), (tt[toks].float() * 59.75).to(
            torch.bfloat16).float().numpy())


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_unembed_returns_f32_logits_and_softcap_keeps_dtype(dt):
    rng = np.random.default_rng(3)
    table = _j(rng.normal(size=(50, 32)).astype(np.float32)).astype(dt)
    x = _j(rng.normal(size=(2, 3, 32)).astype(np.float32)).astype(dt)
    want = jlayers.softcap(jlayers.unembed({"table": table}, x), 30.0)
    to_t = lambda a: _t(a.astype(jnp.float32)).to(getattr(torch, dt))
    logits = players.unembed({"table": to_t(table)}, to_t(x))
    got = players.softcap(logits, 30.0)
    assert logits.dtype == got.dtype == torch.float32
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    half = players.softcap(torch.ones(3, dtype=torch.bfloat16) * 40, 30.0)
    assert half.dtype == torch.bfloat16
    assert players.softcap(logits, None) is logits


def test_gated_mlp_matches():
    rng = np.random.default_rng(4)
    cfg = PCFG
    jp = jmlp.mlp_init(jax.random.PRNGKey(5), JCFG)
    x = rng.normal(size=(1, 6, cfg.d_model)).astype(np.float32)
    want = jmlp.mlp(jp, _j(x))
    got = pmlp.mlp({k: _t(v) for k, v in jp.items()},
                   torch.from_numpy(x[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[0], atol=1e-5,
                               rtol=1e-5)


# ====================================================== weights and pools
def test_params_from_numpy_unstacks_in_scan_order():
    jcfg, pcfg = CONFIGS["gemma2_smoke"]
    jp, pp = _params("gemma2_smoke")
    seg = jcfg.layout()[0]
    assert len(pp["layers"]) == pcfg.n_layers
    for r in range(seg.repeat):
        for i in range(len(seg.pattern)):
            layer = pp["layers"][r * len(seg.pattern) + i]
            src = jp["segments"][0][i]
            for path in (("attn", "wq"), ("mlp", "w_down"),
                         ("post_norm_mlp", "scale")):
                np.testing.assert_array_equal(
                    layer[path[0]][path[1]].numpy(),
                    np.asarray(src[path[0]][path[1]][r]))
    np.testing.assert_array_equal(pp["embed"]["table"].numpy(),
                                  np.asarray(jp["embed"]["table"]))
    # bf16 weights carry over bit for bit
    jb = J.init_params(jax.random.PRNGKey(1), jcfg.replace(dtype="bfloat16"))
    pb = P.params_from_numpy(_np_tree(jb), pcfg.replace(dtype="bfloat16"),
                             device="cpu")
    assert pb["layers"][3]["attn"]["wo"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        pb["layers"][3]["attn"]["wo"].view(torch.int16).numpy().view(
            np.uint16),
        np.asarray(jb["segments"][0][1]["attn"]["wo"][1]).view(np.uint16))


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_pools_round_trip_bit_for_bit(kv):
    jcfg, pcfg = CONFIGS["gemma2_smoke"]
    rng = np.random.default_rng(6)
    tree = _np_tree(J.init_paged_pools(jcfg, 5, 4, kv_dtype=kv))
    tree = jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * 3).astype(a.dtype), tree)
    pools = P.pools_from_numpy(tree, pcfg, device="cpu")
    assert len(pools) == pcfg.n_layers
    back = P.pools_to_numpy(pools, pcfg)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.shape == b.shape
        assert a.tobytes() == b.tobytes()


# ======================================================= paged mixed step
def _schedule(pcfg, bs):
    """Two ticks of packed work over three request rows: tick 1 packs a
    prefill chunk, a full short prompt and a decode row whose context is
    already in the pool; tick 2 continues the chunk, decodes, and verifies
    a 3-token speculative row.  Returns the block tables and per-tick
    (tokens, positions, rows, sample_idx)."""
    rng = np.random.default_rng(7)
    T = 24
    bt = np.asarray([[1, 2, 3, 4, 5, -1], [6, 7, -1, -1, -1, -1],
                     [8, 9, 10, -1, -1, -1]], np.int32)

    def pack(parts):
        toks = np.zeros(T, np.int32)
        pos = np.full(T, -1, np.int32)
        rows = np.full(T, -1, np.int32)
        sidx = np.zeros((3, 3), np.int32)
        n = 0
        for row, start, length in parts:
            toks[n:n + length] = rng.integers(0, pcfg.vocab_size, length)
            pos[n:n + length] = np.arange(start, start + length)
            rows[n:n + length] = row
            sidx[row] = n + np.minimum(np.arange(3), length - 1)
            n += length
        return toks, pos, rows, sidx

    # row 2's context [0, 9) is written by tick 1 as a 9-token chunk
    tick1 = pack([(0, 0, 10), (1, 0, 5), (2, 0, 9)])
    tick2 = pack([(0, 10, 8), (1, 5, 1), (2, 9, 3)])
    return bt, [tick1, tick2]


# configs whose two packages store some K/V value of an int8 / fp8 pool one
# quantization step apart (ROADMAP.md Queue 3, F2): an f32 value before
# quantization lies within an ulp of a rounding boundary, and the two
# packages' products and RoPE differ in the last bit
STEP_APART = ("danube3_smoke",)
QUANTIZED = ("int8", "fp8_e4m3")


def _pool_layers(tree):
    """The leaves of a pool tree in the JAX layout (segments of pattern
    positions, the segment's copies stacked first), one dict per layer in
    the flat layer order: copy r, pattern position i."""
    for seg in tree:
        for r in range(len(seg[0]["k"])):
            for leaves in seg:
                yield {n: np.asarray(a)[r] for n, a in leaves.items()}


def _codes(a):
    """Stored int8 / fp8-e4m3 codes as integers that count quantization
    steps: int8 as is; fp8 (sign and magnitude bits) as +-magnitude bits,
    which step by one between neighbouring values of one sign."""
    if a.dtype == np.int8:
        return a.astype(np.int64)
    bits = a.view(np.uint8).astype(np.int64)
    return np.where(bits & 0x80, -(bits & 0x7F), bits & 0x7F)


def _assert_first_difference_is_one_step(theirs, mine):
    """Up to the first layer whose stored codes differ, the packages store
    the same codes and the same scales (to f32 rounding), and in that layer
    no code is more than one step away.  Later layers read the moved value,
    so their codes may drift further."""
    for a, b in zip(_pool_layers(theirs), _pool_layers(mine)):
        for n in ("k_scale", "v_scale"):        # block 0: pad lanes scribble
            np.testing.assert_allclose(b[n][1:], a[n][1:], rtol=1e-5)
        steps = max(int(np.abs(_codes(a[n][1:]) - _codes(b[n][1:])).max())
                    for n in ("k", "v"))
        assert steps <= 1, steps
        if steps:
            return


@pytest.mark.parametrize("name,kv", [(name, kv) for name in CONFIGS
                                     for kv in KV_DTYPES])
def test_paged_mixed_step_matches_jax(name, kv):
    jcfg, pcfg = CONFIGS[name]
    jp, pp = _params(name)
    bs, N = 4, 12
    bt, ticks = _schedule(pcfg, bs)
    jpools = J.init_paged_pools(jcfg, N, bs, kv_dtype=kv)
    ppools = P.init_paged_pools(pcfg, N, bs, kv_dtype=kv, device="cpu")
    ptrs = [p["k"].data_ptr() for p in ppools]
    for toks, pos, rows, sidx in ticks:
        want, jpools = _jmixed(jp, jpools, _j(bt), _j(toks), _j(pos), _j(rows),
                               _j(sidx), cfg=jcfg)
        got = P.paged_mixed_step(pp, ppools, torch.from_numpy(bt),
                                 *(torch.from_numpy(a)
                                   for a in (toks, pos, rows, sidx)), pcfg)
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        # f32 pools, and int8 / fp8 pools where both packages store the
        # same codes, hold the same values on both sides: 1e-4.  With a
        # bf16 pool the JAX XLA path rounds its P·V product to bf16 while
        # the port accumulates in f32 as the JAX kernel does (ROADMAP.md
        # Queue 3, F1; the kernel path is held tightly below); a code one
        # step apart moves every later layer (F2): the ladder, scaled to
        # the logits, in both cases
        loose = kv == "bfloat16" or (kv in QUANTIZED and name in STEP_APART)
        tol = LADDER[kv] * np.abs(want).max() if loose else 1e-4
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=1e-4)
    # in place: the same storage, every step
    assert [p["k"].data_ptr() for p in ppools] == ptrs
    # every pool leaf but block 0 (where pad lanes scribble in any order)
    theirs, mine = _np_tree(jpools), P.pools_to_numpy(ppools, pcfg)
    if kv in QUANTIZED:
        _assert_first_difference_is_one_step(theirs, mine)
    if kv in QUANTIZED and name in STEP_APART:
        # past the first moved code the codes drift: hold the dequantized
        # values to the ladder, scaled to the values
        for a, b in zip(_pool_layers(theirs), _pool_layers(mine)):
            for n in ("k", "v"):
                va, vb = (_f32(x[n])[1:] * x[n + "_scale"][1:, ..., None]
                          for x in (a, b))
                np.testing.assert_allclose(
                    vb, va, atol=LADDER[kv] * np.abs(va).max(),
                    rtol=LADDER[kv])
    else:
        for a, b in zip(jax.tree.leaves(theirs), jax.tree.leaves(mine)):
            np.testing.assert_allclose(_f32(b)[:, 1:], _f32(a)[:, 1:],
                                       atol=LADDER[kv], rtol=LADDER[kv])


def test_two_chunk_mixed_step_reproduces_prefill_then_decode():
    """tests/test_mixed_tick.py:58 on the port: a prompt prefilled in two
    packed chunks, then decoded one packed token, reproduces the JAX
    package's phase-separated paged_prefill + paged_decode_step."""
    jp, pp = _params("test")
    bs = 4
    prompt = np.arange(1, 11, dtype=np.int32)
    bt1 = _j(np.asarray([[1, 2, 3, -1]], np.int32))
    pools = J.init_paged_pools(JCFG, num_blocks=10, block_size=bs)
    logits_ref, pools_ref = J.paged_prefill(
        jp, pools, bt1, _j(prompt)[None], jnp.arange(10, dtype=jnp.int32)[None],
        JCFG)
    tok = int(jnp.argmax(logits_ref[0]))
    dl_ref, _ = J.paged_decode_step(jp, pools_ref, bt1,
                                    jnp.asarray([tok], jnp.int32),
                                    jnp.asarray([[10]], jnp.int32), JCFG)
    T = 8
    btR = torch.tensor([[1, 2, 3, -1], [-1, -1, -1, -1]], dtype=torch.int32)

    def pack(toks, poss, sidx):
        t = np.zeros(T, np.int32)
        p = np.full(T, -1, np.int32)
        r = np.full(T, -1, np.int32)
        t[:len(toks)], p[:len(poss)], r[:len(poss)] = toks, poss, 0
        return [torch.from_numpy(a) for a in (t, p, r,
                                              np.asarray(sidx, np.int32))]

    ppools = P.init_paged_pools(PCFG, 10, bs, device="cpu")
    P.paged_mixed_step(pp, ppools, btR, *pack(prompt[:6], range(6), [0, 0]),
                       PCFG)
    lg = P.paged_mixed_step(pp, ppools, btR,
                            *pack(prompt[6:], range(6, 10), [3, 0]), PCFG)
    np.testing.assert_allclose(lg[0].numpy(), np.asarray(logits_ref[0]),
                               atol=1e-4, rtol=1e-4)
    assert int(torch.argmax(lg[0])) == tok
    dlg = P.paged_mixed_step(pp, ppools, btR, *pack([tok], [10], [0, 0]),
                             PCFG)
    np.testing.assert_allclose(dlg[0].numpy(), np.asarray(dl_ref[0]),
                               atol=1e-4, rtol=1e-4)


def test_moe_and_embeds_configs_build_and_mamba_pools_raise():
    """MoE layers build their params and paged pools; an embeds config
    builds the reference's tree (the embedding table, and a head when
    untied) but no paged pool; a config with Mamba-2 layers has no paged
    pool."""
    moe = PCFG.replace(n_experts=4, top_k=2)
    pools = P.init_paged_pools(moe, 4, 4, device="cpu")
    params = P.init_params(moe, device="cpu")
    assert len(pools) == len(params["layers"]) == moe.n_layers
    assert all("moe" in p and "mlp" not in p for p in params["layers"])
    embeds = PCFG.replace(input_mode="embeds", tie_embeddings=False)
    eparams = P.init_params(embeds, device="cpu")
    assert eparams["embed"]["table"].shape == \
        eparams["head"]["table"].shape == (embeds.vocab_size, embeds.d_model)
    assert len(eparams["layers"]) == embeds.n_layers
    with pytest.raises(ValueError, match="paged"):
        P.init_paged_pools(embeds, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        P.init_paged_pools(get_config("mamba2-1.3b", smoke=True), 4, 4,
                           device="cpu")


def test_qk_norm_and_untied_head_match_jax():
    """qk-norm (gemma3-style) and an untied head ride the same step."""
    jcfg = JCFG.replace(qk_norm=True, tie_embeddings=False)
    pcfg = PCFG.replace(qk_norm=True, tie_embeddings=False)
    jp = J.init_params(jax.random.PRNGKey(3), jcfg)
    pp = P.params_from_numpy(_np_tree(jp), pcfg, device="cpu")
    assert "head" in pp and "q_norm" in pp["layers"][0]["attn"]
    bt, ticks = _schedule(pcfg, 4)
    jpools = J.init_paged_pools(jcfg, 12, 4)
    ppools = P.init_paged_pools(pcfg, 12, 4, device="cpu")
    for toks, pos, rows, sidx in ticks:
        want, jpools = _jmixed(jp, jpools, _j(bt), _j(toks), _j(pos), _j(rows),
                               _j(sidx), cfg=jcfg)
        got = P.paged_mixed_step(pp, ppools, torch.from_numpy(bt),
                                 *(torch.from_numpy(a)
                                   for a in (toks, pos, rows, sidx)), pcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
    own = P.init_params(pcfg, torch.Generator().manual_seed(0), device="cpu")
    assert own["head"]["table"].shape == (pcfg.vocab_size, pcfg.d_model)


# ============================================================ forward
_jforward = jax.jit(J.forward, static_argnames=("cfg", "mode"))


def _tokens(vocab, B, S, seed):
    """Random tokens and contiguous positions 0..S-1 (K2 assumes them, in
    both packages)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return toks, np.tile(np.arange(S, dtype=np.int32), (B, 1))


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax_score(name, backend):
    """The port's forward (K2's plain version) against the JAX forward in
    score mode on its XLA path and on its Pallas kernel in interpret mode;
    24 tokens cross the SMOKE configs' window of 8."""
    jcfg, pcfg = CONFIGS[name]
    jp, pp = _params(name)
    toks, pos = _tokens(pcfg.vocab_size, 2, 24, 11)
    want, jaux = _jforward(jp, _j(toks), _j(pos),
                           cfg=jcfg.replace(attn_backend=backend),
                           mode="score")
    got, aux = P.forward(pp, torch.from_numpy(toks), torch.from_numpy(pos),
                         pcfg)
    assert got.dtype == torch.float32
    assert got.shape == (2, 24, pcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert aux.dtype == torch.float32 and float(aux) == float(jaux) == 0.0


def test_forward_modes_and_unported_inputs():
    _, pp = _params("test")
    toks, pos = (torch.from_numpy(a) for a in _tokens(PCFG.vocab_size, 1, 9,
                                                      12))
    score, _ = P.forward(pp, toks, pos, PCFG)
    train, _ = P.forward(pp, toks, pos, PCFG, mode="train")
    assert torch.equal(score, train)             # remat only, in JAX
    with pytest.raises(ValueError, match="mode"):
        P.forward(pp, toks, pos, PCFG, mode="prefill")
    # input_mode="embeds": the looked-up embeddings, fed in as (B, S, d),
    # give the token forward's logits (this config scales no embedding)
    x = pp["embed"]["table"][toks.long()]
    embedded, _ = P.forward(pp, x, pos, PCFG.replace(input_mode="embeds"))
    assert embedded.shape == (1, 9, PCFG.vocab_size)
    assert torch.equal(embedded, score)


def test_forward_logits_equal_a_packed_paged_prefill():
    """One prompt scored by ``forward`` (K2's path) and prefilled as one
    packed chunk by ``paged_mixed_step`` (K1's path) gives the same logits
    at every sampled position."""
    jcfg, pcfg = CONFIGS["gemma2_smoke"]
    _, pp = _params("gemma2_smoke")
    S, bs = 20, 4
    toks, pos = _tokens(pcfg.vocab_size, 1, S, 13)
    scored, _ = P.forward(pp, torch.from_numpy(toks), torch.from_numpy(pos),
                          pcfg)
    at = [0, 7, 13, 19]
    pools = P.init_paged_pools(pcfg, 8, bs, device="cpu")
    packed = P.paged_mixed_step(
        pp, pools, torch.arange(1, 6, dtype=torch.int32)[None],
        torch.from_numpy(toks[0]), torch.from_numpy(pos[0]),
        torch.zeros(S, dtype=torch.int32),
        torch.tensor([at], dtype=torch.int32), pcfg)
    np.testing.assert_allclose(packed[0].numpy(), scored[0, at].numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["test", "gemma2_smoke"])
def test_bf16_pool_step_matches_the_jax_kernel_path(name):
    """F1 closed: with a bf16 pool the JAX package's own ragged kernel (run
    in interpret mode) widens the pool to f32 and accumulates P·V in f32, as
    the port does, so the two agree within 1e-4 of the logit scale on the
    configs where F1 was found; only its XLA path, which rounds P·V to
    bf16, needs the bf16 ladder above."""
    jcfg, pcfg = CONFIGS[name]
    jcfg = jcfg.replace(attn_backend="pallas_interpret")
    jp, pp = _params(name)
    bt, ticks = _schedule(pcfg, 4)
    jpools = J.init_paged_pools(jcfg, 12, 4, kv_dtype="bfloat16")
    ppools = P.init_paged_pools(pcfg, 12, 4, kv_dtype="bfloat16",
                                device="cpu")
    for toks, pos, rows, sidx in ticks:
        want, jpools = _jmixed(jp, jpools, _j(bt), _j(toks), _j(pos), _j(rows),
                               _j(sidx), cfg=jcfg)
        got = P.paged_mixed_step(pp, ppools, torch.from_numpy(bt),
                                 *(torch.from_numpy(a)
                                   for a in (toks, pos, rows, sidx)), pcfg)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-4 * np.abs(want).max(), rtol=1e-4)
