"""dbrx-132b: 40L d6144 48H (GQA kv=8) ff10752 vocab100352, MoE 16e top-4
[hf:databricks/dbrx-base; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", kind="moe", n_layers=40, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=10752, vocab=100352, head_dim=128,
    n_experts=16, top_k=4, rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="dbrx-smoke", kind="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=96, vocab=256, head_dim=16, n_experts=4, top_k=2,
    remat="none", q_chunk=8, kv_chunk=8,
)
