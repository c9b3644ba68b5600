"""musicgen-large [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=2048 32H (GQA kv=32 = MHA) d_ff=8192 vocab=2048.
Backbone only: the EnCodec frontend is a stub — the caller supplies
precomputed frame embeddings (B,S,2048); the 4-codebook output heads are
simplified to a single 2048-way head (backbone mandate).  Upstream MusicGen
uses an ungated GELU MLP; we use the framework's gated MLP at the same d_ff
(noted deviation, params +⅓ on the MLP block).
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "musicgen-large"

CONFIG = ModelConfig(
    name=ARCH_ID, family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048,
    input_mode="embeds", tie_embeddings=True,
    rope_theta=10_000.0,
    notes="frontend stubbed: frame embeddings in; single codebook head",
)

SMOKE = CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                       head_dim=16, d_ff=128, vocab_size=64, dtype="float32",
                       q_chunk=16)
