"""qwen3-32b: 64L d5120 64H (GQA kv=8) ff25600 vocab151936 — qk_norm,
GQA, head_dim 128 [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", kind="dense", n_layers=64, d_model=5120, n_heads=64,
    n_kv_heads=8, d_ff=25600, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", kind="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, qk_norm=True,
    remat="none", q_chunk=8, kv_chunk=8,
)
