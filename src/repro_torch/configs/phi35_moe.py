"""phi3.5-moe-42b-a6.6b: 32L d4096 32H (GQA kv=8) ff6400 vocab32064,
MoE 16e top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", kind="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=6400, vocab=32064, head_dim=128,
    n_experts=16, top_k=2, rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="phi35-moe-smoke", kind="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=96, vocab=256, head_dim=16, n_experts=4, top_k=2,
    remat="none", q_chunk=8, kv_chunk=8,
)
