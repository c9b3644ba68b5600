"""Port parity: the stages of K3's tensor-core route, emulated by the plain
versions in ``kernels/ssd/ref.py``, against the JAX package on the CPU.

The same inputs, made with numpy from a seed, go through the JAX oracle
(``ssd_ref``, the sequential recurrence), the JAX model's ``ssd_chunked``
(with an initial state), the TPU kernel in interpret mode, and the port's
``ssd_stages_ref``: the chunk state (with cum_a and C·Bᵀ), the pass over
the chunk states and the chunk scan, composed as the CUDA kernels run
them, with ``split=True`` rounding each f32 operand of the tensor-core
products (B ⊙ w, the weighted scores, h_prev) to bf16 hi + lo, and
``pad=True`` padding Q to 64 and P and N to 16 with zeros, as the kernels
pad their tiles.  Tolerance: the JAX suite's SSD one, 5e-4 + 1e-3 |ref|
element by element (``tests/test_kernels.py``), the one ``chip_smoke.py``
holds the kernel to on the card.  bf16 inputs are x, B and C rounded to
bf16, which the JAX functions take as the same values in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd as jssd
from repro.kernels.ssd.ref import ssd_ref
from repro.models import mamba2 as jmamba
from repro_torch.kernels.ssd import ops, ref

torch.set_num_threads(1)

_jchunked = jax.jit(jmamba.ssd_chunked, static_argnames=("chunk",))
TOL = dict(atol=5e-4, rtol=1e-3)
# (B, S, H, P, N, chunk): the cases of test_torch_ssd.py, then a Q of 100
# (not a multiple of 64) with P 24 and N 40, and P 20, N 36 over a ragged
# tail (P and N not multiples of 16)
CASES = [(2, 64, 2, 16, 16, 16),
         (1, 100, 4, 32, 16, 32),
         (2, 128, 2, 64, 128, 64),
         (1, 17, 2, 16, 8, 32),
         (2, 33, 3, 16, 16, 16),
         (1, 150, 3, 24, 40, 100),
         (2, 90, 2, 20, 36, 64)]
DTYPES = ["float32", "bfloat16"]


def _inputs(B, S, H, P, N, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(f32)
    B_ = (rng.standard_normal((B, S, N)) / np.sqrt(N)).astype(f32)
    C_ = (rng.standard_normal((B, S, N)) / np.sqrt(N)).astype(f32)
    D = rng.standard_normal(H).astype(f32)
    h0 = (0.5 * rng.standard_normal((B, H, P, N))).astype(f32)
    if dtype == "bfloat16":
        x, B_, C_ = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                     for a in (x, B_, C_))
    return x, dt, A, B_, C_, D, h0


def _torch(x, dt, A, B_, C_, D, h0, dtype):
    td = getattr(torch, dtype)
    t = torch.from_numpy
    return (t(x).to(td), t(dt), t(A), t(B_).to(td), t(C_).to(td), t(D),
            t(h0))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_stages_match_the_sequential_oracle(case, dtype):
    """With the hi/lo rounding, the D-term and h0, against the JAX
    package's step-by-step recurrence."""
    B, S, H, P, N, chunk = case
    arrays = _inputs(B, S, H, P, N, sum(case), dtype)
    x, dt, A, B_, C_, D, h0 = arrays
    y_r, h_r = ssd_ref(*map(jnp.asarray, (x, dt, A, B_, C_, D)),
                       h0=jnp.asarray(h0))
    tx, tdt, tA, tB, tC, tD, th0 = _torch(*arrays, dtype)
    y, h = ref.ssd_stages_ref(tx, tdt, tA, tB, tC, tD, chunk=chunk, h0=th0,
                              split=True, pad=True)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    _close(y, y_r)
    _close(h, h_r)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_stages_match_ssd_chunked_with_h0(case, dtype):
    """The function the JAX Mamba-2 block runs: no D-term, an initial
    state."""
    B, S, H, P, N, chunk = case
    arrays = _inputs(B, S, H, P, N, sum(case) + 1, dtype)
    x, dt, A, B_, C_, _, h0 = arrays
    y_r, h_r = _jchunked(*map(jnp.asarray, (x, dt, A, B_, C_)),
                         chunk=chunk, h0=jnp.asarray(h0))
    tx, tdt, tA, tB, tC, _, th0 = _torch(*arrays, dtype)
    y, h = ref.ssd_stages_ref(tx, tdt, tA, tB, tC, chunk=chunk, h0=th0,
                              split=True, pad=True)
    _close(y, y_r)
    _close(h, h_r)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[5]], ids=str)
def test_stages_match_the_interpret_mode_kernel(case, dtype):
    """The TPU kernel (D inside, no h0) in f32 on the same values; for
    bf16 the values are bf16-representable, so the kernel's f32 y is the
    function of the bf16 inputs."""
    B, S, H, P, N, chunk = case
    arrays = _inputs(B, S, H, P, N, sum(case) + 2, dtype)
    x, dt, A, B_, C_, D, _ = arrays
    y_k, h_k = jssd(*map(jnp.asarray, (x, dt, A, B_, C_, D)), chunk=chunk,
                    interpret=True)
    tx, tdt, tA, tB, tC, tD, _ = _torch(*arrays, dtype)
    y, h = ref.ssd_stages_ref(tx, tdt, tA, tB, tC, tD, chunk=chunk,
                              split=True, pad=True)
    _close(y, y_k)
    _close(h, h_k)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_composed_stages_equal_ssd_chunked_ref(case, split):
    """Without the rounding the stages are ``ssd_chunked_ref``'s arithmetic
    in another order (f32 sums: 2e-5, the JAX suite's f32 tolerance); with
    it, within the SSD tolerance."""
    B, S, H, P, N, chunk = case
    tx, tdt, tA, tB, tC, tD, th0 = _torch(*_inputs(B, S, H, P, N,
                                                    sum(case) + 3),
                                          "float32")
    y_r, h_r = ref.ssd_chunked_ref(tx, tdt, tA, tB, tC, tD, chunk=chunk,
                                   h0=th0)
    y, h = ref.ssd_stages_ref(tx, tdt, tA, tB, tC, tD, chunk=chunk, h0=th0,
                              split=split)
    tol = TOL if split else dict(atol=2e-5, rtol=2e-5)
    _close(y, y_r, **tol)
    _close(h, h_r, **tol)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_zero_padding_leaves_outputs_unchanged(case, split):
    """Q padded to 64 and P and N to 16 with zeros (the kernels' shared
    tiles): padded rows have dt = 0 and padded columns add zero products,
    so y and h_final stay within one f32 summation order (2e-6)."""
    B, S, H, P, N, chunk = case
    args = _torch(*_inputs(B, S, H, P, N, sum(case) + 4), "bfloat16")
    tx, tdt, tA, tB, tC, tD, th0 = args
    y0, h0 = ref.ssd_stages_ref(tx, tdt, tA, tB, tC, tD, chunk=chunk,
                                h0=th0, split=split)
    y1, h1 = ref.ssd_stages_ref(tx, tdt, tA, tB, tC, tD, chunk=chunk,
                                h0=th0, split=split, pad=True)
    torch.testing.assert_close(y1, y0, atol=2e-6, rtol=2e-6)
    torch.testing.assert_close(h1, h0, atol=2e-6, rtol=2e-6)


def test_split_bf16_keeps_sixteen_bits():
    """hi + lo is exact in f32 and within 2^-16 of the value, relative."""
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32)) * 100
    s = ref.split_bf16(v)
    hi = v.to(torch.bfloat16).float()
    assert torch.equal(s - hi, (v - hi).to(torch.bfloat16).float())
    assert bool(((s - v).abs() <= v.abs() * 2.0 ** -16).all())


def test_state_pass_writes_the_state_before_each_chunk():
    rng = np.random.default_rng(1)
    states = torch.from_numpy(rng.standard_normal((2, 5, 3, 4, 6))
                              .astype(np.float32))
    cum_end = -torch.from_numpy(rng.random((2, 5, 3)).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((2, 3, 4, 6))
                          .astype(np.float32))
    h_prev, h_final = ref.ssd_state_pass(states, cum_end, h0)
    assert torch.equal(h_prev[:, 0], h0)
    for c in range(1, 5):
        want = torch.exp(cum_end[:, c - 1])[..., None, None] * h_prev[:, c - 1] \
            + states[:, c - 1]
        assert torch.equal(h_prev[:, c], want)
    want = torch.exp(cum_end[:, 4])[..., None, None] * h_prev[:, 4] \
        + states[:, 4]
    assert torch.equal(h_final, want)


def test_route_and_workspace_follow_dtype_and_shape():
    """bf16 takes the tensor cores, f32 the FMA kernel; the workspace at
    mamba2-1.3b's S = 4500 layer (18 chunks of 256) is the chunk states,
    C·Bᵀ and cum_a in f32."""
    x = torch.empty((1, 4500, 64, 64), dtype=torch.bfloat16)
    B_ = torch.empty((1, 4500, 128), dtype=torch.bfloat16)
    assert ops.ssd_route(x) == "tensor_core"
    assert ops.ssd_route(x.float()) == "fma"
    assert ops.workspace_bytes(x.float(), B_.float(), 256) == 0
    want = 4 * (18 * 64 * 64 * 128 + 18 * 256 * 256 + 18 * 64 * 256)
    assert ops.workspace_bytes(x, B_, 256) == want
    # a ragged Q rounds up to 64 rows, each part to 64 floats
    x = torch.empty((2, 90, 2, 20), dtype=torch.bfloat16)
    B_ = torch.empty((2, 90, 36), dtype=torch.bfloat16)
    parts = (2 * 2 * 2 * 20 * 36, 2 * 2 * 64 * 64, 2 * 2 * 2 * 64)
    assert ops.workspace_bytes(x, B_, 64) == 4 * sum(
        -(-p // 64) * 64 for p in parts)
