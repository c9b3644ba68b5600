"""Port parity: the in-dispatch samplers of the PyTorch port against the JAX
package (``models/sampling.py``).

Greedy sampling and greedy speculative verify are deterministic, so tokens
and accept counts must be equal and scores within 1e-5.  Sampled verify
draws from torch's generator, not JAX's, so it is held by distribution: the
seeded chi-square harness of tests/test_speculative.py, run on the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import sample_with_scores as jsample
from repro.models import speculative_verify as jverify
from repro_torch.models import sample_with_scores, speculative_verify

torch.set_num_threads(1)


def test_greedy_sample_with_scores_matches():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(6, 50)) * 3).astype(np.float32)
    logits[2, 7] = logits[2, 9] = logits[2].max() + 1     # a tie: first wins
    jt, js = jsample(jnp.asarray(logits), 0, 0.0)
    tt, ts = sample_with_scores(torch.from_numpy(logits), 0, 0.0)
    assert tt.dtype == torch.int32 and int(tt[2]) == 7
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("K", [0, 1, 3])
def test_greedy_speculative_verify_matches(K):
    rng = np.random.default_rng(K)
    R, V = 7, 40
    logits = (rng.normal(size=(R, K + 1, V)) * 2).astype(np.float32)
    argmax = logits.argmax(-1)
    drafts = rng.integers(0, V, size=(R, K)).astype(np.int32)
    for r in range(R):                  # planted accepted prefixes
        a = r % (K + 1)
        drafts[r, :a] = argmax[r, :a]
    dlen = (np.arange(R) % (K + 1)).astype(np.int32)
    jt, ja, js = jverify(jnp.asarray(logits), jnp.asarray(drafts),
                         jnp.asarray(dlen), 0, 0.0)
    tt, ta, ts = speculative_verify(torch.from_numpy(logits),
                                    torch.from_numpy(drafts),
                                    torch.from_numpy(dlen), 0, 0.0)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5,
                               rtol=1e-5)
    if K:
        assert ta.numpy().max() > 0


def test_greedy_verify_accepts_matching_prefix():
    V = 8
    chain = [3, 5, 2, 7]
    logits = np.full((3, 4, V), -4.0, np.float32)
    for i, t in enumerate(chain):
        logits[:, i, t] = 4.0
    drafts = np.asarray([[3, 5, 9], [3, 5, 2], [0, 0, 0]], np.int32)
    dlen = np.asarray([3, 3, 0], np.int32)
    toks, n_acc, scores = speculative_verify(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        torch.from_numpy(dlen), 0, 0.0)
    assert n_acc.tolist() == [2, 3, 0]
    assert toks[0].tolist() == chain and toks[1].tolist() == chain
    assert int(toks[2, 0]) == chain[0]
    assert torch.isfinite(scores).all()


def test_sampled_verify_emits_the_target_distribution():
    """Rejection sampling is lossless on the port too: for a good drafter
    (draft = target mode) and an adversarial one (anti-mode), the first
    emitted token follows the target distribution, and so does the second
    given acceptance — chi-square, df = 7, bound 30 (0.999 quantile 24.3),
    seeded so the statistic is deterministic."""
    V, K, temp = 8, 2, 1.0
    rng = np.random.default_rng(0)
    logits1 = (rng.normal(size=(1, K + 1, V)) * 1.5).astype(np.float32)
    p0 = torch.softmax(torch.from_numpy(logits1[0, 0]) / temp, -1).numpy()
    p1 = torch.softmax(torch.from_numpy(logits1[0, 1]) / temp, -1).numpy()
    R = 4000
    logits = torch.from_numpy(logits1).expand(R, K + 1, V).contiguous()

    def chi2(counts, probs, n):
        return float(np.sum((counts - n * probs) ** 2 / (n * probs)))

    for name, d0 in (("mode", int(np.argmax(p0))),
                     ("antimode", int(np.argmin(p0)))):
        drafts = torch.tensor([[d0, int(np.argmax(p1))]],
                              dtype=torch.int32).expand(R, K)
        dlen = torch.full((R,), K, dtype=torch.int32)
        c0, c1, cv = np.zeros(V), np.zeros(V), np.zeros(V)
        n1 = 0
        for seed in range(5):
            toks, n_acc, _ = speculative_verify(logits, drafts, dlen, seed,
                                                temp)
            toks, n_acc = toks.numpy(), n_acc.numpy()
            np.add.at(c0, toks[:, 0], 1)
            sel = n_acc >= 1
            np.add.at(c1, toks[sel, 1], 1)
            n1 += int(sel.sum())
            vt, _ = sample_with_scores(logits[:, 0, :], seed + 1000, temp)
            np.add.at(cv, vt.numpy(), 1)
        N = R * 5
        assert chi2(c0, p0, N) < 30, f"{name}: first-token dist diverged"
        assert chi2(cv, p0, N) < 30
        assert 0.5 * np.abs(c0 / N - cv / N).sum() < 0.05
        assert n1 > 300
        assert chi2(c1, p1, n1) < 30, f"{name}: post-accept dist diverged"
