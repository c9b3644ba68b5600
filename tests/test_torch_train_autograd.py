"""Port parity for K2's and K3's autograd Functions against the JAX
package on the CPU.

The JAX train step differentiates its XLA attention (``_attend_chunked``)
and its pure-JAX chunked SSD (``models/mamba2.py::ssd_chunked``); the
port's wrappers run their plain versions on CPU tensors and differentiate
them through ``torch.autograd.Function``s whose forward is the routed call
(the kernel on the card).  The same inputs, made with numpy from a seed, go
through ``jax.vjp`` and ``torch.autograd.grad``.  Tolerances are the
reference's train-step ones (``tests/test_training_ft.py:53``: rtol 2e-4,
atol 2e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ref import ssd_ref
from repro.models import mamba2 as jmamba
from repro.models.attention import _attend_chunked
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd import ops as ssd_ops

torch.set_num_threads(1)

LEAF_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_training_ft.py:53


# ============================================= the autograd Functions
def _attn_inputs(seed, B, S, H, K, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D),
                      (B, S, H, D))]


# (B, S, H, K, D, window, softcap, q_chunk): the JAX path chunks queries
# past q_chunk, the port's plain version past 512
ATTN_CASES = [(2, 40, 4, 2, 16, None, None, 16),
              (1, 48, 4, 1, 8, 12, None, 16),
              (2, 33, 4, 4, 16, None, 20.0, 8),
              (1, 64, 6, 2, 32, 17, 30.0, 16)]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_attention_grads_match_jax_vjp(case):
    B, S, H, K, D, window, cap, q_chunk = case
    q, k, v, dout = _attn_inputs(sum(case[:5]), B, S, H, K, D)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    scale = D ** -0.5

    def f(q, k, v):
        return _attend_chunked(q, k, v, pos, pos, window=window, cap=cap,
                               scale=scale, q_chunk=q_chunk)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got_out = fa_ops.flash_attention(qt, kt, vt, window=window, softcap=cap)
    assert got_out.grad_fn is not None
    got = torch.autograd.grad(got_out, (qt, kt, vt), torch.from_numpy(dout))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               **LEAF_TOL)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **LEAF_TOL)


def test_flash_attention_function_forward_is_the_routed_call():
    q, k, v, _ = _attn_inputs(3, 1, 24, 4, 2, 16)
    plain = fa_ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   window=7, softcap=15.0)
    args = [torch.from_numpy(a).requires_grad_(i == 1)
            for i, a in enumerate((q, k, v))]
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(*args, window=7, softcap=15.0)
    assert torch.equal(out.detach(), plain)
    assert fa_ops.flash_attention.launches == before == 0   # CPU: no launch
    with torch.no_grad():
        assert fa_ops.flash_attention(*args, window=7,
                                      softcap=15.0).grad_fn is None


def _ssd_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x=rng.standard_normal((B, S, H, P)).astype(f32),
        dt=np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f32),
        A=(-np.exp(rng.standard_normal(H) * 0.5)).astype(f32),
        B_=(rng.standard_normal((B, S, N)) / np.sqrt(N)).astype(f32),
        C_=(rng.standard_normal((B, S, N)) / np.sqrt(N)).astype(f32),
        D=rng.standard_normal(H).astype(f32),
        h0=(0.5 * rng.standard_normal((B, H, P, N))).astype(f32),
        dy=rng.standard_normal((B, S, H, P)).astype(f32),
        dh=rng.standard_normal((B, H, P, N)).astype(f32))


# (B, S, H, P, N, chunk, with h0 and D, h_final's grad used)
SSD_CASES = [(2, 64, 2, 16, 16, 16, True, True),
             (1, 37, 3, 8, 4, 16, True, False),
             (2, 40, 2, 16, 8, 64, False, True),
             (1, 33, 2, 8, 16, 8, False, False)]


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_grads_match_jax_vjp(case):
    """Grads of every operand (x, dt, A, B_, C_, and D and h0 where given)
    against JAX's vjp of its pure-JAX ``ssd_chunked`` (D added as D·x in
    f32, as the port's wrapper adds it); h_final's grad None where only y
    is used."""
    B, S, H, P, N, chunk, extras, use_h = case
    a = _ssd_inputs(sum(case[:6]), B, S, H, P, N)
    names = ["x", "dt", "A", "B_", "C_"] + (["D", "h0"] if extras else [])

    def f(x, dt, A, B_, C_, D=None, h0=None):
        y, h = jmamba.ssd_chunked(x, dt, A, B_, C_, chunk=chunk, h0=h0)
        if D is not None:
            y = y + D[None, None, :, None] * x
        return y, h

    (y, h), vjp = jax.vjp(f, *(jnp.asarray(a[n]) for n in names))
    want = vjp((jnp.asarray(a["dy"]),
                jnp.asarray(a["dh"] if use_h else np.zeros_like(a["dh"]))))
    ts = {n: torch.from_numpy(a[n]).requires_grad_() for n in names}
    gy, gh = ssd_ops.ssd(ts["x"], ts["dt"], ts["A"], ts["B_"], ts["C_"],
                         ts.get("D"), chunk=chunk, h0=ts.get("h0"))
    np.testing.assert_allclose(gy.detach().numpy(), np.asarray(y),
                               **LEAF_TOL)
    np.testing.assert_allclose(gh.detach().numpy(), np.asarray(h),
                               **LEAF_TOL)
    outs = [(gy, torch.from_numpy(a["dy"]))]
    if use_h:
        outs.append((gh, torch.from_numpy(a["dh"])))
    got = torch.autograd.grad([o for o, _ in outs], [ts[n] for n in names],
                              [g for _, g in outs])
    for n, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=n,
                                   **LEAF_TOL)


def test_ssd_function_forward_is_the_routed_call():
    a = _ssd_inputs(5, 1, 20, 2, 8, 4)
    ops_in = [torch.from_numpy(a[n]) for n in ("x", "dt", "A", "B_", "C_")]
    plain = ssd_ops.ssd(*ops_in, chunk=8)
    before = ssd_ops.ssd.launches
    graded = ssd_ops.ssd(ops_in[0].clone().requires_grad_(), *ops_in[1:],
                         chunk=8)
    for p, g in zip(plain, graded):
        assert g.grad_fn is not None and torch.equal(g.detach(), p)
    assert ssd_ops.ssd.launches == before == 0            # CPU: no launch


def test_ssd_grads_stay_finite_where_the_reference_overflows():
    """ROADMAP F13: once a chunk's decay sum passes exp's range (here dt
    3..4, A = -1, 32 steps a chunk), the JAX package's ``ssd_chunked``
    gives NaN gradients for dt and A (it selects exp(rel) away above the
    diagonal after computing it: 0·inf in the backward).  The port's plain
    version zeroes rel first: the same forward, and grads that match the
    JAX sequential oracle's (``kernels/ssd/ref.py::ssd_ref``)."""
    rng = np.random.default_rng(13)
    B, S, H, P, N, chunk = 1, 64, 2, 4, 4, 32
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (3 + rng.random((B, S, H))).astype(np.float32)
    A = -np.ones(H, np.float32)
    B_ = rng.standard_normal((B, S, N)).astype(np.float32)
    C_ = rng.standard_normal((B, S, N)).astype(np.float32)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, dt, A, B_, C_)]

    _, vjp = jax.vjp(lambda *a: jmamba.ssd_chunked(*a, chunk=chunk)[0],
                     *args)
    broken = vjp(jnp.asarray(dy))
    assert bool(jnp.isnan(broken[1]).any()) and bool(
        jnp.isnan(broken[2]).any())
    y_seq, vjp_seq = jax.vjp(lambda *a: ssd_ref(*a)[0], *args)
    want = vjp_seq(jnp.asarray(dy))

    ts = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, B_, C_)]
    y, _ = ssd_ops.ssd(*ts, chunk=chunk)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_seq),
                               atol=5e-4, rtol=1e-3)
    got = torch.autograd.grad(y, ts, torch.from_numpy(dy))
    for n, g, w in zip(("x", "dt", "A", "B_", "C_"), got, want):
        assert bool(torch.isfinite(g).all()), n
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=5e-4 * float(np.abs(w).max()),
                                   err_msg=n)
