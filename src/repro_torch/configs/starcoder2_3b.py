"""starcoder2-3b: 30L d3072 24H (GQA kv=2) ff12288 vocab49152 — GQA,
RoPE, LayerNorm + GELU MLP with bias [arXiv:2402.19173; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", kind="dense", n_layers=30, d_model=3072,
    n_heads=24, n_kv_heads=2, d_ff=12288, vocab=49152,
    norm="layernorm", act="gelu", qkv_bias=True, rope_theta=100_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke", kind="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, norm="layernorm",
    act="gelu", qkv_bias=True, tie_embeddings=True, remat="none",
    q_chunk=8, kv_chunk=8,
)
