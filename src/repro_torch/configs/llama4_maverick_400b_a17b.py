"""llama4-maverick-400b-a17b [moe] — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
Interleaved MoE (every 2nd layer, as in Maverick) + 1 shared expert lands
total params at ~398B with ~17B active — matching the name.  Trains with
Adafactor by default (Adam moments for 400B exceed a 256-chip pod's HBM).
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "llama4-maverick-400b-a17b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048, tie_embeddings=False,
    n_experts=128, top_k=1, n_shared_experts=1, moe_d_ff=8192, moe_every=2,
    capacity_factor=1.25,
    optimizer="adafactor",
    rope_theta=500_000.0,
    notes="config tagged unverified upstream; moe_every=2 to land 400B/17B-active",
)

SMOKE = CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=128, vocab_size=256, n_experts=8,
                       moe_d_ff=32, dtype="float32", q_chunk=16)
