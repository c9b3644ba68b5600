"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; hf].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "h2o-danube-1.8b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
    d_ff=6912, vocab_size=32000, tie_embeddings=False,
    window=4096,
    rope_theta=10_000.0,
)

SMOKE = CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=128, vocab_size=256, window=8,
                       dtype="float32", q_chunk=16)
