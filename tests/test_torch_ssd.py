"""Port parity: the SSD chunked scan (K3's plain version and wrapper) and
the Mamba-2 block of the PyTorch port against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX oracle
(``ssd_ref``, the sequential recurrence), the JAX model's ``ssd_chunked``
(with an initial state), the TPU kernel in interpret mode (with the D-term,
y cast to x's dtype) and the port's ``kernels/ssd/ops.ssd``, which runs its
plain version for CPU tensors.  Tolerances are the JAX suite's SSD ones
(``tests/test_kernels.py``: atol 5e-4, rtol 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.kernels.ssd.ops import ssd as jssd
from repro.kernels.ssd.ref import ssd_ref
from repro.models import mamba2 as jmamba
from repro_torch.configs.registry import get_config
from repro_torch.kernels.ssd import ops
from repro_torch.models import mamba2 as pmamba

torch.set_num_threads(1)

_jchunked = jax.jit(jmamba.ssd_chunked, static_argnames=("chunk",))
_jblock = jax.jit(jmamba.mamba_block, static_argnames=("cfg",))
TOL = dict(atol=5e-4, rtol=1e-3)
# (B, S, H, P, N, chunk): the JAX suite's SSD_CASES (a ragged S among
# them), a prompt shorter than the chunk (Q = S = 17) and a ragged tail of
# one step
CASES = [(2, 64, 2, 16, 16, 16),
         (1, 100, 4, 32, 16, 32),
         (2, 128, 2, 64, 128, 64),
         (1, 17, 2, 16, 8, 32),
         (2, 33, 3, 16, 16, 16)]


def _inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(f32)
    B_ = (rng.standard_normal((B, S, N)) / np.sqrt(N)).astype(f32)
    C_ = (rng.standard_normal((B, S, N)) / np.sqrt(N)).astype(f32)
    D = rng.standard_normal(H).astype(f32)
    h0 = (0.5 * rng.standard_normal((B, H, P, N))).astype(f32)
    return x, dt, A, B_, C_, D, h0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_ssd_matches_the_sequential_oracle(case):
    B, S, H, P, N, chunk = case
    x, dt, A, B_, C_, D, h0 = _inputs(B, S, H, P, N, sum(case))
    y_r, h_r = ssd_ref(*map(jnp.asarray, (x, dt, A, B_, C_, D)),
                       h0=jnp.asarray(h0))
    y, h = ops.ssd(*_t(x, dt, A, B_, C_, D), chunk=chunk,
                   h0=torch.from_numpy(h0))
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), **TOL)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_ssd_matches_ssd_chunked_with_h0(case):
    """The function the JAX Mamba-2 block runs: no D-term, an initial
    state, f32 y."""
    B, S, H, P, N, chunk = case
    x, dt, A, B_, C_, _, h0 = _inputs(B, S, H, P, N, sum(case) + 1)
    y_r, h_r = _jchunked(*map(jnp.asarray, (x, dt, A, B_, C_)),
                         chunk=chunk, h0=jnp.asarray(h0))
    y, h = ops.ssd(*_t(x, dt, A, B_, C_), chunk=chunk,
                   h0=torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES[1:3], ids=str)
def test_plain_ssd_matches_the_interpret_mode_kernel(case, dtype):
    """The TPU kernel (D inside, y in x's dtype) against the port's f32 y
    rounded to that dtype once; bf16 at the suite's bf16 tolerance 2e-2."""
    B, S, H, P, N, chunk = case
    x, dt, A, B_, C_, D, _ = _inputs(B, S, H, P, N, sum(case) + 2)
    if dtype == "bfloat16":
        x, B_, C_ = (np.array(jnp.asarray(a, jnp.bfloat16).astype(
            jnp.float32)) for a in (x, B_, C_))
    jd = jnp.dtype(dtype)
    y_k, h_k = jssd(jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A),
                    jnp.asarray(B_, jd), jnp.asarray(C_, jd), jnp.asarray(D),
                    chunk=chunk, interpret=True)
    td = getattr(torch, dtype)
    y, h = ops.ssd(torch.from_numpy(x).to(td), torch.from_numpy(dt),
                   torch.from_numpy(A), torch.from_numpy(B_).to(td),
                   torch.from_numpy(C_).to(td), torch.from_numpy(D),
                   chunk=chunk)
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(y.to(td).float().numpy(),
                               np.asarray(y_k.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_k), **TOL)


def test_ssd_wrapper_checks_operands_and_counts_only_launches():
    x, dt, A, B_, C_, D, h0 = _t(*_inputs(1, 16, 2, 8, 4, 0))
    before = ops.ssd.launches
    ops.ssd(x, dt, A, B_, C_, D, chunk=8, h0=h0)
    assert ops.ssd.launches == before            # plain version: no launch
    with pytest.raises(TypeError, match="dtypes"):
        ops.ssd(x.to(torch.bfloat16), dt, A, B_, C_, chunk=8)
    with pytest.raises(TypeError, match="dt must be float32"):
        ops.ssd(x, dt.double(), A, B_, C_, chunk=8)
    with pytest.raises(ValueError, match="do not fit"):
        ops.ssd(x, dt[:, :8], A, B_, C_, chunk=8)
    with pytest.raises(ValueError, match="h0"):
        ops.ssd(x, dt, A, B_, C_, chunk=8, h0=h0[:, :1])
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd(x, dt.transpose(1, 2).contiguous().transpose(1, 2), A, B_,
                C_, chunk=8)
    wide = torch.zeros((1, 16, 2, 65))
    with pytest.raises(ValueError, match="head_dim"):
        ops.ssd(wide, dt, A, B_, C_, chunk=8)


def _block_params(jcfg, seed):
    """One Mamba-2 layer's params from the JAX initialiser, with A_log,
    dt_bias, D and the conv bias drawn away from their constant inits."""
    jp = jmamba.mamba_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    H = jcfg.ssm_heads
    jp = dict(jp, A_log=jnp.asarray(rng.standard_normal(H) * 0.3, jnp.float32),
              dt_bias=jnp.asarray(rng.standard_normal(H) * 0.3, jnp.float32),
              D=jnp.asarray(rng.standard_normal(H), jnp.float32),
              conv_b=jnp.asarray(rng.standard_normal(jp["conv_b"].shape)
                                 * 0.1, jnp.float32))
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_mamba_block_matches_jax(arch):
    """Full sequence, prefill from a non-zero state (S > 1 with a cache,
    through K3 with h0) and one decode step (the plain SSM step) give the
    JAX block's outputs and new caches within 1e-4 at f32."""
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jp, pp = _block_params(jcfg, 5)
    rng = np.random.default_rng(6)
    B, S = 2, 19                        # > ssm_chunk (8): three chunks
    x = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
    cache = {"conv": (rng.standard_normal((B, cfg.conv_width - 1,
                                           cfg.d_inner + 2 * cfg.ssm_state))
                      * 0.5).astype(np.float32),
             "ssm": (rng.standard_normal((B, cfg.ssm_heads, cfg.ssm_head_dim,
                                          cfg.ssm_state)) * 0.5
                     ).astype(np.float32)}
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    pc = {k: torch.from_numpy(v) for k, v in cache.items()}
    for xs, jcache, pcache in ((x, None, None), (x, jc, pc),
                               (x[:, :1], jc, pc)):
        want, wc = _jblock(jp, jnp.asarray(xs), cfg=jcfg, cache=jcache)
        got, gc = pmamba.mamba_block(pp, torch.from_numpy(xs), cfg=cfg,
                                     cache=pcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
        assert (gc is None) == (wc is None)
        for k in (wc or {}):
            np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]),
                                       atol=1e-4, rtol=1e-4)
    assert torch.equal(pc["ssm"], torch.from_numpy(cache["ssm"]))  # untouched
