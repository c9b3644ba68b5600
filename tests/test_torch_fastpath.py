"""Port parity: the device fast path (``repro_torch.core.fastpath``) against
the JAX package's ``repro.core.fastpath`` on the CPU.

The three tests of ``tests/test_fastpath_devstore.py`` that drive the fast
path run on both packages with the same numpy input: fused == chained ==
broker, the grouping of collocated stages, and the donation discipline of
``FastPathPipeline.build`` (spying on ``fuse_stages``), each within 1e-6 of
the JAX result.  Then the port's own contracts: ``broker_hop`` brings a
bfloat16 tensor back bit for bit, ``handoff`` never crosses host memory,
the fused rung runs eagerly on a CPU input, and its capture cache takes a
bound of at least one graph (its CUDA-graph path, with the donation and
the eviction it documents, needs the card: ``chip_smoke.py``'s
``fastpath`` phase drives it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastpath as jfp
from repro_torch.core import (FastPathPipeline, Stage, broker_hop,
                              chain_stages, fuse_stages, handoff)
from repro_torch.core import fastpath as pfp

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
X = np.random.default_rng(0).standard_normal(8).astype(np.float32)


def _stages(mod, tanh):
    return [mod.Stage("a", lambda x: x * 2.0),
            mod.Stage("b", lambda x: x + 1.0),
            mod.Stage("c", tanh)]


def _both():
    return (_stages(jfp, jnp.tanh), _stages(pfp, torch.tanh))


def test_fused_equals_chained_equals_broker():
    """``tests/test_fastpath_devstore.py::test_fused_equals_chained_equals_
    broker`` on both packages: every rung gives tanh(2x + 1)."""
    js, ps = _both()
    x = jnp.asarray(X)
    want = np.asarray(jfp.fuse_stages(js, donate=False)(x))
    np.testing.assert_allclose(want, np.tanh(X * 2.0 + 1.0), rtol=1e-6)
    jhop = x
    for st in js:
        jhop = st.fn(jfp.broker_hop(jhop))
    t = torch.from_numpy(X.copy())
    fused = fuse_stages(ps, donate=False)(t)
    chained = chain_stages(ps)(torch.from_numpy(X.copy()))
    hopped = t
    for st in ps:
        hopped = st.fn(broker_hop(hopped))
    for got in (fused, chained, hopped):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(hopped.numpy(), np.asarray(jhop), **TOL)
    assert torch.equal(t, torch.from_numpy(X))       # input untouched


def test_fastpath_pipeline_groups_collocated_stages():
    js, ps = _both()
    want = np.asarray(jfp.FastPathPipeline(js).build()(jnp.asarray(X)))
    got = FastPathPipeline(ps).build()(torch.from_numpy(X.copy()))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _spied_builds(mod, monkeypatch, stages):
    """The ``donate`` flags ``build`` passes to ``fuse_stages``, with and
    without ``donate_input``, and each built pipeline."""
    seen = []
    real = mod.fuse_stages

    def spy(stages, *, donate=True):
        seen.append(donate)
        return real(stages, donate=donate)

    monkeypatch.setattr(mod, "fuse_stages", spy)
    runs = []
    for donate_input in (False, True):
        runs.append(mod.FastPathPipeline(stages).build(
            donate_input=donate_input))
        seen.append("|")
    return seen, runs


def test_fastpath_pipeline_donates_intermediate_groups(monkeypatch):
    """Three placement groups (None, a placed stage, None): every group
    after the first is donated, the first only on ``donate_input=True``
    ([False, True, True] / [True, True, True], as the JAX package's build
    passes them), and the caller's input is still readable afterwards."""
    place = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    jstages = [jfp.Stage("a", lambda x: x * 2.0),
               jfp.Stage("b", lambda x: x + 1.0),
               jfp.Stage("c", lambda x: x - 3.0, out_sharding=place),
               jfp.Stage("d", lambda x: jnp.tanh(x))]
    pstages = [pfp.Stage("a", lambda x: x * 2.0),
               pfp.Stage("b", lambda x: x + 1.0),
               pfp.Stage("c", lambda x: x - 3.0, out_device="cpu"),
               pfp.Stage("d", lambda x: torch.tanh(x))]
    jseen, jruns = _spied_builds(jfp, monkeypatch, jstages)
    pseen, pruns = _spied_builds(pfp, monkeypatch, pstages)
    assert pseen == jseen == [False, True, True, "|", True, True, True, "|"]
    x = jnp.asarray(X)
    want = np.asarray(jruns[0](x))
    t = torch.from_numpy(X.copy())
    got = pruns[0](t)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(want, np.tanh(X * 2.0 + 1.0 - 3.0),
                               rtol=1e-6)
    # the caller's input was not donated and is still readable
    np.testing.assert_array_equal(t.numpy(), X)
    np.testing.assert_allclose(
        pruns[1](torch.from_numpy(X.copy())).numpy(),
        np.asarray(jruns[1](jnp.asarray(X))), **TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float8_e4m3fn, torch.int32])
def test_broker_hop_round_trips_bit_exactly(dtype):
    """numpy has no bfloat16 or fp8: those cross the wire as raw bits, and
    every dtype comes back bit for bit, with its shape, as a new tensor."""
    g = torch.Generator().manual_seed(1)
    x = (torch.randn((3, 5, 7), generator=g) * 4).to(dtype)
    back = broker_hop(x)
    assert back.dtype == dtype and back.shape == x.shape
    assert back.data_ptr() != x.data_ptr()
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()]
    assert torch.equal(back.view(bits), x.view(bits))


def test_handoff_stays_off_host_memory():
    """``handoff`` moves device to device; between the host and a card it
    raises (that move is ``broker_hop``), and a CPU tensor to the CPU is
    itself."""
    t = torch.arange(4.0)
    assert handoff(t, "cpu") is t
    with pytest.raises(ValueError, match="host memory"):
        handoff(t, "cuda")


def test_fused_rung_runs_eagerly_on_the_cpu_and_takes_extra_args():
    """A CPU input never reaches the CUDA-graph path (no capture, no
    replay); extra arguments reach every stage, as in the JAX package."""
    stages = [pfp.Stage("scale", lambda x, s: x * s),
              pfp.Stage("shift", lambda x, s: x + s)]
    fused = fuse_stages(stages)
    s = torch.tensor(3.0)
    out = fused(torch.from_numpy(X.copy()), s)
    jout = jfp.fuse_stages([jfp.Stage("scale", lambda x, s: x * s),
                            jfp.Stage("shift", lambda x, s: x + s)],
                           donate=False)(jnp.asarray(X), jnp.float32(3.0))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert fused.captures == fused.replays == 0


@pytest.mark.parametrize("max_graphs", [0, -1])
def test_fused_rung_keeps_at_least_one_capture(max_graphs):
    """``max_graphs`` bounds the captures a fused group keeps; a bound
    below one would capture at every call and is refused."""
    with pytest.raises(ValueError, match="max_graphs"):
        fuse_stages(_stages(pfp, torch.tanh), max_graphs=max_graphs)
    fused = fuse_stages(_stages(pfp, torch.tanh), max_graphs=1)
    out = fused(torch.from_numpy(X.copy()))
    np.testing.assert_allclose(out.numpy(), np.tanh(X * 2.0 + 1.0), **TOL)
    assert fused.captures == fused.evictions == 0
