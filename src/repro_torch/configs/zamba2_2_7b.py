"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf].

54L d_model=2560 32H (kv=32 = MHA) d_ff=10240 vocab=32000, ssm_state=64.
Layout: 9 × (6 mamba2 layers + 1 shared-attention application); the shared
transformer block (one parameter set, applied 9×) takes concat(hidden,
original embeddings) (2d) as input, per the Zamba design.  Per-application
LoRA deltas are omitted (noted simplification, DESIGN §4).  head_dim 160 =
2d/32.  `long_500k` runs: mamba state is O(1) and the 9 shared-attn caches
hold full context (sequence-sharded).
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "zamba2-2.7b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=160,
    d_ff=10240, vocab_size=32000, tie_embeddings=True,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    conv_width=4, shared_attn_every=6,
    rope_theta=10_000.0,
    notes="shared-block LoRA deltas omitted; 54 = 9 groups of 6",
)

SMOKE = CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                       head_dim=32, d_ff=128, vocab_size=256, ssm_state=16,
                       ssm_head_dim=16, ssm_chunk=8, shared_attn_every=2,
                       dtype="float32", q_chunk=16)
