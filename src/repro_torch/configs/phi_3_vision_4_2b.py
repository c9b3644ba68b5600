"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend
[hf:microsoft/Phi-3-vision-128k-instruct; hf].

32L d_model=3072 32H (GQA kv=32 = MHA) d_ff=8192 vocab=32064.
Backbone only: the CLIP image tower is a stub — the caller supplies
precomputed patch+text embeddings (B,S,3072).  Untied LM head.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "phi-3-vision-4.2b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064,
    input_mode="embeds", tie_embeddings=False,
    rope_theta=10_000.0,
    notes="CLIP frontend stubbed: patch/text embeddings in",
)

SMOKE = CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                       head_dim=16, d_ff=128, vocab_size=64, dtype="float32",
                       q_chunk=16)
