"""Port parity: one-token decode attention over dense per-slot caches (K4's
plain version and wrapper) and the dense cache path of the port's attention
against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX oracle
``decode_attention_ref``, the TPU kernel ``decode_attention`` in interpret
mode and the port's ``kernels/decode_attention/ops.decode_attention``, which
runs its plain version for CPU tensors: ring buffers, windows, softcaps,
partly filled rows and int8 / fp8 caches with per-slot scales, at the JAX
suite's 2e-5 (``tests/test_kernels.py``).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.kernels.decode_attention import quant as jquant
from repro.kernels.decode_attention.ops import decode_attention as jdecode
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.models import attention as jattn
from repro.models.config import LayerSpec as JSpec
from repro_torch.configs.registry import get_config
from repro_torch.kernels.decode_attention import ops, quant
from repro_torch.models import attention as pattn
from repro_torch.models.config import LayerSpec

torch.set_num_threads(1)

_STATIC = ("window", "softcap", "scale")
jref = jax.jit(decode_attention_ref, static_argnames=_STATIC)
TOL = dict(atol=2e-5, rtol=2e-5)
# (B, S, H, K, D, window, softcap, fill): the JAX suite's DECODE_CASES, a
# ring wrapped past its S slots (fill > S), and zamba2's G = 1 at D = 160
CASES = [(2, 256, 8, 2, 64, None, None, 200),
         (1, 128, 4, 4, 32, 64, None, 128),
         (2, 512, 8, 1, 64, None, 50.0, 300),
         (3, 96, 4, 2, 64, 32, 30.0, 50),
         (2, 64, 4, 2, 32, 48, 50.0, 150),
         (2, 40, 2, 2, 160, None, None, 33)]


def _inputs(B, S, H, K, D, fill, seed):
    """Row b's cache holds positions up to fill - 1 - b: slots in order
    while they last, then a ring (slot = position % S); -1 where empty."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    last = np.asarray([fill - 1 - b for b in range(B)], np.int32)
    slot = np.arange(S)[None, :]
    pos = last[:, None] - ((last[:, None] - slot) % S)
    pos = np.where(pos >= 0, pos, -1).astype(np.int32)
    return q, k, v, last, pos


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_decode_matches_jax_ref_and_kernel(case):
    B, S, H, K, D, win, cap, fill = case
    q, k, v, qpos, pos = _inputs(B, S, H, K, D, fill, sum(case[:5]))
    kw = dict(window=win, softcap=cap)
    got = ops.decode_attention(*_t(q, k, v, qpos, pos), **kw)
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    want = jref(*map(jnp.asarray, (q, k, v, qpos, pos)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    kern = jdecode(*map(jnp.asarray, (q, k, v, qpos, pos)), block_k=32,
                   interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("case", CASES[2:5:2], ids=str)
def test_quantized_cache_matches_the_interpret_mode_kernel(case, kv_dtype):
    """int8 / fp8 caches with (B,S,K) f32 scales: the port's dequantize-
    then-attend against the TPU kernel's in-register dequant, and against
    the oracle on the dequantized values."""
    B, S, H, K, D, win, cap, fill = case
    q, k, v, qpos, pos = _inputs(B, S, H, K, D, fill, 7)
    kq, ks = (np.array(a) for a in jquant.quantize_kv(jnp.asarray(k),
                                                      kv_dtype))
    vq, vs = (np.array(a) for a in jquant.quantize_kv(jnp.asarray(v),
                                                      kv_dtype))
    tdt = torch.int8 if kv_dtype == "int8" else torch.float8_e4m3fn
    bits = np.uint8 if kv_dtype == "fp8_e4m3" else np.int8
    kt, vt = (torch.from_numpy(a.view(bits).copy()).view(tdt)
              for a in (kq, vq))
    kw = dict(window=win, softcap=cap)
    got = ops.decode_attention(torch.from_numpy(q), kt, vt,
                               *_t(qpos, pos), k_scale=torch.from_numpy(ks),
                               v_scale=torch.from_numpy(vs), **kw)
    kern = jdecode(*map(jnp.asarray, (q, kq, vq, qpos, pos)),
                   k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                   block_k=32, interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)
    deq = [np.asarray(jquant.dequantize_kv(jnp.asarray(a), jnp.asarray(s)))
           for a, s in ((kq, ks), (vq, vs))]
    want = jref(*map(jnp.asarray, (q, deq[0], deq[1], qpos, pos)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the port's quantizer stores the same bytes
    pq, _ = quant.quantize_kv(torch.from_numpy(k), kv_dtype)
    assert np.array_equal(pq.view(torch.uint8 if kv_dtype == "fp8_e4m3"
                                  else torch.int8).numpy(), kq.view(bits))


def test_row_with_nothing_visible_averages_its_slots():
    """No slot visible (empty cache): the oracle's softmax over all-NEG_INF
    scores is uniform, and the plain version gives the same average."""
    q, k, v, _, _ = _inputs(2, 16, 4, 2, 32, 1, 3)
    pos = np.full((2, 16), -1, np.int32)
    qpos = np.asarray([5, 0], np.int32)
    got = ops.decode_attention(*_t(q, k, v, qpos, pos))
    want = jref(*map(jnp.asarray, (q, k, v, qpos, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    mean = v.mean(axis=1).repeat(2, axis=1)              # (B, K*G, D)
    np.testing.assert_allclose(got.numpy(), mean, **TOL)


def test_bf16_decode_follows_the_jax_kernel_path():
    """F3: with bf16 caches the JAX XLA dense path (``_attend``) rounds the
    probabilities to bf16 before P·V; the TPU kernel keeps them in f32, and
    so does the port.  The port's output equals the interpret-mode kernel's
    up to the one rounding of the output to bf16."""
    B, S, H, K, D, win, cap, fill = CASES[0]
    q, k, v, qpos, pos = _inputs(B, S, H, K, D, fill, 9)
    bf = lambda a: np.asarray(a, ml_dtypes.bfloat16)
    q, k, v = bf(q), bf(k), bf(v)
    kern = jdecode(*map(jnp.asarray, (q, k, v, qpos, pos)), block_k=64,
                   interpret=True)
    tq, tk, tv = (torch.from_numpy(a.view(np.uint16).copy()).view(
                  torch.bfloat16)
                  for a in (q, k, v))
    got = ops.decode_attention(tq, tk, tv, *_t(qpos, pos))
    assert got.dtype == torch.bfloat16
    want = np.asarray(kern).astype(np.float32)
    err = np.abs(got.float().numpy() - want)
    assert (err <= 2.0 ** -7 * np.abs(want) + 2e-5).all(), err.max()


def test_cpu_tensors_never_count_as_kernel_launches():
    q, k, v, qpos, pos = _inputs(1, 8, 2, 1, 16, 8, 0)
    before = ops.decode_attention.launches
    ops.decode_attention(*_t(q, k, v, qpos, pos))
    assert ops.decode_attention.launches == before


# ====================================================== the dense cache path
_jdecode_attention = jax.jit(jattn.attention, static_argnames=("cfg", "spec"))
_jprefill_cache = jax.jit(jattn.prefill_cache,
                          static_argnames=("cfg", "spec", "max_len"))


def _layer(arch, seed):
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = jattn.attn_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, jax.tree.map(lambda a: torch.from_numpy(
        np.array(a)), jp)


@pytest.mark.parametrize("window", [None, 8])
def test_prefill_cache_and_decode_match_jax(window):
    """``prefill_cache`` (K2's plain version over the prompt, then the cache
    write) and three decode steps through the cache (K4's plain version) on
    gemma2 SMOKE's widths.  With window 8 the 20-token prompt overfills the
    8-slot ring: the port writes only its last 8 positions, and the ring
    then holds what the JAX package's in-order scatter leaves."""
    jcfg, cfg, jp, pp = _layer("gemma2-9b", 1)
    jspec = JSpec("attn_mlp", window, jcfg.rope_theta)
    spec = LayerSpec("attn_mlp", window, cfg.rope_theta)
    rng = np.random.default_rng(2)
    B, S, max_len = 2, 20, 32
    x = rng.standard_normal((B, S + 3, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S + 3, dtype=np.int32), (B, 1))
    want, jc = _jprefill_cache(jp, jnp.asarray(x[:, :S]),
                               jnp.asarray(pos[:, :S]), cfg=jcfg, spec=jspec,
                               max_len=max_len)
    got, pc = pattn.prefill_cache(pp, *_t(x[:, :S], pos[:, :S]), cfg=cfg,
                                  spec=spec, max_len=max_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert pc["k"].shape[1] == (window or max_len)
    for t in range(S, S + 3):
        want, jc = _jdecode_attention(jp, jnp.asarray(x[:, t:t + 1]),
                                      jnp.asarray(pos[:, t:t + 1]), cfg=jcfg,
                                      spec=jspec, cache=jc)
        got, pc = pattn.attention(pp, *_t(x[:, t:t + 1], pos[:, t:t + 1]),
                                  cfg=cfg, spec=spec, cache=pc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
        for leaf in ("k", "v", "pos"):
            np.testing.assert_allclose(pc[leaf].numpy(),
                                       np.asarray(jc[leaf]), atol=1e-5)
    with pytest.raises(NotImplementedError, match="no path"):
        pattn.attention(pp, *_t(x[:, :2], pos[:, :2]), cfg=cfg, spec=spec,
                        cache=pc)
