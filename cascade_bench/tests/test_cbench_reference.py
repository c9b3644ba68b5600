"""The plain references against the port at the registry's SMOKE sizes in
float32, on the same seeded weights: every position's logits.  The port is
imported here, in the test, and never by the references."""
import dataclasses

import numpy as np
import pytest
import torch

from cascade_bench.reference import common, deepseek_moe_16b, zamba2_2_7b

REFS = {"deepseek-moe-16b": deepseek_moe_16b, "zamba2-2.7b": zamba2_2_7b}


def smoke_model(name: str, **over) -> dict:
    from repro_torch.configs.registry import get_config
    m = dataclasses.asdict(get_config(name, smoke=True))
    m.pop("notes")
    m.update(over)
    return m


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the dropless capacity: every (token, expert) entry fits
@pytest.mark.parametrize("name,over", [
    ("deepseek-moe-16b", {"capacity_factor": 8.0}),
    ("zamba2-2.7b", {}),
])
def test_reference_equals_the_port(name, over):
    from repro_torch.models import forward
    from repro_torch.models.config import ModelConfig
    m = smoke_model(name, **over)
    ref = REFS[name]
    params = ref.make_params(m, 2 ** 31 + 77, "cpu")
    S = 40
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, m["vocab_size"], S).astype(np.int32))
    pos = torch.arange(S, dtype=torch.int32)
    got, _ = forward(params, toks[None], pos[None], ModelConfig(**m))
    want = ref.logits(params, m, toks, torch.arange(S), "f32")
    assert torch.allclose(got[0], want, rtol=1e-4, atol=1e-4), \
        float((got[0] - want).abs().max())
    # the float8 control strays by far more than float32 rounding
    low = ref.logits(params, m, toks, torch.arange(S), "fp8")
    assert float((low - want).abs().max()) > 100 * float(
        (got[0] - want).abs().max())


def test_weights_come_from_the_seed():
    m = smoke_model("zamba2-2.7b")
    a = zamba2_2_7b.make_params(m, 7, "cpu")
    b = zamba2_2_7b.make_params(m, 7, "cpu")
    c = zamba2_2_7b.make_params(m, 8, "cpu")
    wa = a["layers"][0]["mamba"]["in_proj"]
    assert torch.equal(wa, b["layers"][0]["mamba"]["in_proj"])
    assert not torch.equal(wa, c["layers"][0]["mamba"]["in_proj"])
    # one fan-in scaled draw: about unit variance after the scale
    assert 0.5 < float(wa.float().std() * m["d_model"] ** 0.5) < 2.0


def test_fp8_rounds_each_product():
    x = torch.randn(8, 32)
    w = torch.randn(32, 16)
    exact = common.mm(x, w, "f32")
    low = common.mm(x, w, "fp8")
    rel = float((low - exact).norm() / exact.norm())
    assert 1e-3 < rel < 0.2
    with pytest.raises(ValueError):
        common.mm(x, w, "bf16")


def test_ssd_chunks_equal_the_recurrence():
    torch.manual_seed(0)
    S, H, P, N = 11, 2, 3, 4
    x, B, C = torch.randn(S, H, P), torch.randn(S, N), torch.randn(S, N)
    dt, A = torch.rand(S, H), -torch.rand(H)
    got = zamba2_2_7b.ssd(x, dt, A, B, C, chunk=4)
    h = torch.zeros(H, P, N)
    for t in range(S):
        h = torch.exp(dt[t] * A)[:, None, None] * h + \
            (dt[t][:, None] * x[t])[:, :, None] * B[t][None, None, :]
        assert torch.allclose(got[t], h @ C[t], atol=1e-5)
