"""gemma3-4b [dense] — 5:1 local:global, 128k context
[hf:google/gemma-3-1b-pt; unverified].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.
Pattern: 5 local (window 1024, RoPE θ=10k) then 1 global (θ=1M); 34 = 5×6+4
→ five full patterns + a 4-local remainder segment.  QK-norm (gemma3
replaces gemma2's logit softcap), pre+post norms, scaled embeddings, tied.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "gemma3-4b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab_size=262144, tie_embeddings=True,
    window=1024, local_global_pattern=5,
    qk_norm=True, post_norm=True, embed_scale=True,
    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    notes="config tagged unverified upstream (hf points at 1b-pt); dims per assignment",
)

SMOKE = CONFIG.replace(n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=128, vocab_size=256, window=8,
                       dtype="float32", q_chunk=16)
