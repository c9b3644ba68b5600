"""K2's plain version under autograd recomputes one query chunk at a time
(``kernels/flash_attention/ref.py``), as the JAX package's chunked
attention wraps its chunk body in ``jax.checkpoint``
(``models/attention.py``), on the CPU.

The checkpoint changes no bit: the forward, and the grads of q, k and v,
equal those of the same function with the checkpoint taken out (a stand-in
that calls the chunk directly).  On meta, under the dry run's counter,
K2's backward (``ops._FlashAttention``, which differentiates the plain
version) then holds about one chunk's f32 scores at a time, where without
the checkpoint it keeps every chunk's softmax until the backward reaches
it.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.launch.costs import CostCounter

torch.set_num_threads(1)


def _direct(monkeypatch):
    """``attention_ref`` with each chunk called directly, no checkpoint."""
    monkeypatch.setattr(ref, "checkpoint",
                        lambda fn, *args, use_reentrant: fn(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,cap", [(None, None), (24, 5.0)])
def test_checkpointed_chunks_change_no_bit(monkeypatch, dtype, window, cap):
    """S = 70 over chunks of 16 (a ragged last chunk), GQA 4 over 2: the
    output and the q, k, v grads with the checkpointed chunks equal them
    without the checkpoint, and the output equals the no-grad forward's,
    bit for bit."""
    g = torch.Generator().manual_seed(0)
    B, S, H, K, D = 2, 70, 4, 2, 8
    make = lambda *shape: torch.randn(shape, generator=g).to(dtype)
    q, k, v = make(B, S, H, D), make(B, S, K, D), make(B, S, K, D)
    dout = make(B, S, H, D)
    kw = dict(window=window, softcap=cap, q_chunk=16)

    def run():
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ref.attention_ref(*qkv, **kw)
        return out, torch.autograd.grad(out, qkv, dout)

    out, grads = run()
    with torch.no_grad():
        plain = ref.attention_ref(q, k, v, **kw)
    with monkeypatch.context() as mp:
        _direct(mp)
        out2, grads2 = run()
    assert torch.equal(out, plain) and torch.equal(out, out2)
    for a, b in zip(grads, grads2):
        assert torch.equal(a, b)


def _backward_peak(monkeypatch, checkpointed: bool) -> int:
    """The most bytes K2's backward holds at once, on meta: B 2, S 4,096,
    H = K = 8, D 64, bf16, causal (chunks of 512)."""
    B, S, H, D = 2, 4096, 8, 64
    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16,
                                  device="meta").requires_grad_()
    q, k, v = meta(B, S, H, D), meta(B, S, H, D), meta(B, S, H, D)
    with monkeypatch.context() as mp:
        if not checkpointed:
            _direct(mp)
        out = ops.flash_attention(q, k, v)
        counter = CostCounter()
        with counter:
            torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    return counter.per_device()["peak_bytes"]


def test_the_backward_holds_one_chunk_of_scores_at_a_time(monkeypatch):
    """K2's backward at (B 2, S 4,096, H 8) holds at most four tensors of
    the last chunk's f32 scores (B·H·512·S·4 bytes: the scores, their
    softmax, and those two's grads) beside the f32 copies of q, k, v and
    their grads; without the checkpoint it holds more than that (every
    chunk's softmax kept until the backward reaches it: 8.3 chunks' worth
    here, and more the longer the sequence)."""
    B, S, H, D = 2, 4096, 8, 64
    chunk = B * H * 512 * S * 4
    qkv = 6 * B * S * H * D * 4
    bound = 4 * chunk + qkv
    assert _backward_peak(monkeypatch, True) <= bound
    assert _backward_peak(monkeypatch, False) > bound
