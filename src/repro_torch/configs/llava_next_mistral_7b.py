"""llava-next-mistral-7b: 32L d4096 32H (GQA kv=8) ff14336 vocab32000 —
anyres tiling; vision frontend STUB (input_specs provides patch
embeddings) [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", kind="llava", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000, n_patches=576,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="llava-smoke", kind="llava", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, n_patches=4, remat="none",
    q_chunk=8, kv_chunk=8,
)
