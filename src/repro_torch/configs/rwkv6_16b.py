"""rwkv6-1.6b ("Finch"): 24L d2048 (attn-free) ff7168 vocab65536 —
data-dependent decay [arXiv:2404.05892; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", kind="rwkv6", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=7168, vocab=65536,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", kind="rwkv6", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, remat="none",
)
