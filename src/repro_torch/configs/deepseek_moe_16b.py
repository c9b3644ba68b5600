"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained experts
[arXiv:2401.06066; hf].

28L d_model=2048 16H (kv=16 = MHA) expert d_ff=1408 vocab=102400.
Layer 0 is a dense FFN (d_ff=10944) per the paper; layers 1-27 are MoE with
64 fine-grained routed experts (top-6) + 2 shared experts of the same 1408
hidden size.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "deepseek-moe-16b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944, vocab_size=102400, tie_embeddings=False,
    n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
    first_layer_dense=True, capacity_factor=1.25,
    rope_theta=10_000.0,
    notes="assignment lists d_ff=1408 (expert hidden); dense layer-0 uses 10944 per paper",
)

SMOKE = CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                       head_dim=16, d_ff=128, vocab_size=256, n_experts=8,
                       top_k=2, moe_d_ff=32, dtype="float32", q_chunk=16)
