"""h2o-danube-3-4b [dense] — llama+mistral mix, SWA
[arXiv:2401.16818; unverified].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.
Assignment says SWA; the public 3-series reportedly dropped SWA — we follow
the assignment (window 8192, noted unverified).
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "h2o-danube-3-4b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
    d_ff=10240, vocab_size=32000, tie_embeddings=True,
    window=8192,
    rope_theta=500_000.0,
    notes="unverified upstream; SWA per assignment line",
)

SMOKE = CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=128, vocab_size=256, window=8,
                       dtype="float32", q_chunk=16)
