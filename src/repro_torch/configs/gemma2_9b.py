"""gemma2-9b [dense] — local+global alternating, logit softcaps
[arXiv:2408.00118; hf].

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.
Alternation: 1 local (window 4096) : 1 global; attention logit softcap 50,
final logit softcap 30; pre+post norms; scaled, tied embeddings; head_dim
256 (> d_model/heads, per the public config).
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "gemma2-9b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000, tie_embeddings=True,
    window=4096, local_global_pattern=1,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    post_norm=True, embed_scale=True,
    rope_theta=10_000.0,
)

SMOKE = CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=128, vocab_size=256, window=8,
                       dtype="float32", q_chunk=16)
