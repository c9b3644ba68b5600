"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified].

48L d_model=2048 vocab=50280 (padded to 50288 = 16·3143 for TP sharding, the
same pad_vocab_size_multiple the reference implementation applies),
ssm_state=128, expand 2 → d_inner 4096, head_dim 64 → 64 SSD heads.
`long_500k` runs: decode state is O(1) in sequence length.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "mamba2-1.3b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=50288, tie_embeddings=True,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    conv_width=4,
    notes="vocab padded 50280→50288 (×16) for sharding",
)

SMOKE = CONFIG.replace(n_layers=4, d_model=64, vocab_size=256, ssm_state=16,
                       ssm_head_dim=16, ssm_chunk=8, dtype="float32")
