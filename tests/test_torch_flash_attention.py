"""Port parity: the plain PyTorch version of the flash-attention kernel (K2)
against the JAX package's oracle and its Pallas kernel in interpret mode.

The same inputs, made from numpy seeds, go through the JAX package's
``attention_ref`` and ``flash_attention(..., interpret=True)`` and through
the port's wrapper on CPU tensors (which runs the plain version).  The CUDA
kernel itself is held against this plain version on the card by
``chip_smoke.py``'s ``flash_kernel`` phase.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro_torch.kernels.flash_attention import ops, ref

torch.set_num_threads(1)

# tests/test_kernels.py:23 FLASH_CASES, then head_dim 80 and 120 (the
# h2o-danube widths, the first that are not powers of two)
FLASH_CASES = [
    # (B, S, H, K, D, window, softcap, dtype)
    (2, 128, 4, 2, 64, None, None, "float32"),
    (1, 256, 4, 4, 64, 64, None, "float32"),
    (2, 100, 8, 2, 32, None, 50.0, "float32"),
    (1, 96, 4, 1, 64, 32, 30.0, "float32"),
    (1, 64, 2, 2, 128, None, None, "bfloat16"),
    (1, 80, 8, 4, 16, 16, None, "bfloat16"),
    (1, 100, 8, 2, 80, 24, None, "float32"),
    (2, 72, 4, 2, 120, None, 30.0, "float32"),
    (1, 96, 4, 1, 80, 16, 50.0, "bfloat16"),
    (1, 70, 4, 2, 120, 40, None, "bfloat16"),
]

# tests/test_kernels.py:50 FLASH_SWEEP: (s, h, g, win, blk), S = 16 s, D = 32
FLASH_SWEEP = [
    (2, 2, 1, None, 16),
    (3, 4, 2, 8, 32),
    (4, 2, 2, 24, 16),
    (5, 4, 1, None, 32),
    (2, 4, 2, 24, 32),
    (5, 2, 1, 8, 16),
    (3, 2, 2, None, 32),
    (4, 4, 1, 24, 16),
]


def _inputs(seed, B, S, H, K, D, dtype):
    """numpy q, k, v rounded to ``dtype``, as JAX arrays and CPU tensors
    holding the same values."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(B, S, n, D)).astype(np.float32)
              for n in (H, K, K)]
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32))


@pytest.mark.parametrize("B,S,H,K,D,win,cap,dt", FLASH_CASES)
def test_plain_version_matches_jax_ref_and_kernel(B, S, H, K, D, win, cap,
                                                  dt):
    (jq, jk, jv), (q, k, v) = _inputs(S * 10 + D, B, S, H, K, D, dt)
    want_ref = jref(jq, jk, jv, window=win, softcap=cap)
    want_kernel = jflash(jq, jk, jv, window=win, softcap=cap, interpret=True,
                         block_q=32, block_k=32)
    got = ops.flash_attention(q, k, v, window=win, softcap=cap)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 2e-5 if dt == "float32" else 2e-2        # tests/test_kernels.py:43
    for want in (want_ref, want_kernel):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    # query chunks smaller than S, each with only the keys its band and
    # window reach: the same function
    chunked = ref.attention_ref(q, k, v, window=win, softcap=cap, q_chunk=24)
    np.testing.assert_allclose(_f32(chunked), _f32(want_ref), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("s,h,g,win,blk", FLASH_SWEEP)
def test_plain_version_param_sweep(s, h, g, win, blk):
    B, S, D = 1, s * 16, 32
    K = h // g
    (jq, jk, jv), (q, k, v) = _inputs(s * 7 + h, B, S, h, K, D, "float32")
    want_kernel = jflash(jq, jk, jv, window=win, interpret=True, block_q=blk,
                         block_k=blk)
    want_ref = jref(jq, jk, jv, window=win)
    for q_chunk in (blk, 512):
        got = ref.attention_ref(q, k, v, window=win, q_chunk=q_chunk)
        for want in (want_ref, want_kernel):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=3e-5, rtol=3e-5)


def test_positions_are_ignored_as_in_the_jax_kernel():
    _, (q, k, v) = _inputs(4, 1, 20, 4, 2, 16, "float32")
    plain = ops.flash_attention(q, k, v, window=6)
    shifted = ops.flash_attention(q, k, v, window=6,
                                  positions=torch.arange(20)[None] + 100)
    assert torch.equal(plain, shifted)


def test_wrapper_rejects_wrong_dtype_shape_and_grad():
    _, (q, k, v) = _inputs(5, 1, 16, 4, 2, 16, "float32")
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="differs"):
        ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="do not fit"):
        ops.flash_attention(q, k[:, :8].contiguous(), v[:, :8].contiguous())
    with pytest.raises(ValueError, match="do not fit"):
        ops.flash_attention(q[:, :, :3].contiguous(), k, v)   # H % K != 0
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros((1, 4, 2, 264))
        ops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=0)
    # an input that requires grad is no longer rejected: the call goes
    # through the autograd Function, whose forward is the same call
    out = ops.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), ops.flash_attention(q.detach(), k, v))


def test_cpu_tensors_never_count_as_kernel_launches():
    _, (q, k, v) = _inputs(6, 1, 16, 4, 2, 16, "bfloat16")
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, window=4, softcap=20.0)
    assert out.dtype == torch.bfloat16
    assert ops.flash_attention.launches == before == 0


PLAN_DIMS = (16, 32, 64, 80, 120, 128, 160, 256)


def test_shared_memory_fits_every_ported_head_dim():
    def smem(D, dt):
        return ops.launch_plan(D, dt).smem_bytes

    for D in PLAN_DIMS:                         # the H100's opt-in limit
        for dt in (torch.bfloat16, torch.float32):
            assert smem(D, dt) <= 232_448       # per CTA, in bytes
    # bf16: 1 KB of alignment, four 16 KB boxes of q, two stages of four
    # 16 KB K+V boxes, 7 barriers; f32: the FMA kernel's f32 tiles
    assert smem(256, torch.bfloat16) == 1024 + 4 * 16384 * 3 + 7 * 8 == 197_688
    assert smem(256, torch.float32) == 148_992


@pytest.mark.parametrize("D", PLAN_DIMS)
def test_launch_plan_pads_head_dim_and_fills_shared_memory(D):
    plan = ops.launch_plan(D, torch.bfloat16)
    nc = -(-D // 64)
    assert plan.dp == 64 * nc >= D and plan.tile_rows == 128
    assert plan.smem_bytes == (1024 + nc * 16384 * (1 + plan.stages)
                               + 8 * (3 * plan.stages + 1)) <= 232_448
    # as many stages as fit, at most 4, and never fewer than 2 (a load in
    # flight while the other stage is read)
    more = plan.smem_bytes + nc * 16384 + 3 * 8
    assert 2 <= plan.stages <= 4 and (plan.stages == 4 or more > 232_448)
    assert {256: 2, 160: 3}.get(D, 4) == plan.stages
    f32 = ops.launch_plan(D, torch.float32)
    assert (f32.dp, f32.tile_rows, f32.stages) == (D, 64, 1)


def test_card_path_head_dim_rule():
    for D in (8, 72, 96, 248):
        assert ops.launch_plan(D, torch.bfloat16).dp % 64 == 0
    for D in (4, 20, 100, 124, 250):             # not multiples of 8
        with pytest.raises(ValueError, match="multiple of 8"):
            ops.launch_plan(D, torch.bfloat16)
    for D in (0, 264):
        for dt in (torch.bfloat16, torch.float32):
            with pytest.raises(ValueError, match="head_dim"):
                ops.launch_plan(D, dt)
    for D in (1, 20, 100, 250):                  # f32 keeps 1..256
        assert ops.launch_plan(D, torch.float32).dp == D
    # the CPU path runs the plain version for any head_dim the wrapper takes
    _, (q, k, v) = _inputs(7, 1, 12, 2, 1, 20, "bfloat16")
    out = ops.flash_attention(q, k, v)
    assert out.shape == q.shape and out.dtype == torch.bfloat16


# (arch, D, softcap): one chunk of 64 queries at the end of a 2048-token
# causal sequence, at gemma2-9b's and zamba2-2.7b's head widths
SPLIT_CASES = [("gemma2-9b", 256, 50.0), ("zamba2-2.7b", 160, None)]


@pytest.mark.parametrize("arch,D,cap", SPLIT_CASES)
def test_split_p_keeps_pv_at_f32_precision(arch, D, cap):
    """The bf16 kernel feeds P to the tensor cores as p_hi = bf16(p) plus
    p_lo = bf16(p - p_hi).  Emulated here in f64 on bf16 inputs: the split
    P·V stays within 2^-17 Σ p|v| / l of the f32 P·V, and its bf16 output
    within one rounding of the f32 value (chip_smoke's rule); one bf16
    rounding of p breaks that rule."""
    S, C = 2048, 64
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .bfloat16().double() for shape in ((C, D), (S, D), (S, D)))
    s = (q @ k.T).float() * D ** -0.5
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(S - C, S)[:, None]
    s = torch.where(torch.arange(S)[None] <= qpos, s,
                    torch.full_like(s, -float("inf")))
    p = torch.exp(s - s.max(-1, keepdim=True).values)        # f32
    l = p.double().sum(-1, keepdim=True)
    exact = p.double() @ v / l
    hi = p.bfloat16()
    lo = (p - hi.float()).bfloat16()
    split = (hi.double() + lo.double()) @ v / l
    single = hi.double() @ v / l
    bound = 2.0 ** -17 * (p.double() @ v.abs()) / l
    assert bool(((split - exact).abs() <= bound).all())
    assert not bool(((single - exact).abs() <= bound).all())

    def over(x):      # chip_smoke.checked_case's err_over_rounding_bound
        rounded = x.float().bfloat16().double()
        return ((rounded - exact).abs()
                / (exact.abs() * 2.0 ** -8 + 2e-5)).max().item()

    assert over(split) <= 1.0 < over(single)
