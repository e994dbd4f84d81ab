"""minitron-4b: 32L d3072 24H (GQA kv=8) ff9216 vocab256000 — pruned
nemotron [arXiv:2407.14679; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", kind="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=9216, vocab=256000,
)

SMOKE = ModelConfig(
    name="minitron-smoke", kind="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, remat="none",
    q_chunk=8, kv_chunk=8,
)
