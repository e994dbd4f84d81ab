"""qwen1.5-0.5b: 24L d1024 16H (kv=16, MHA) ff2816 vocab151936 — QKV
bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", kind="dense", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=2816, vocab=151936, qkv_bias=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen15-smoke", kind="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, qkv_bias=True, tie_embeddings=True,
    remat="none", q_chunk=8, kv_chunk=8,
)
