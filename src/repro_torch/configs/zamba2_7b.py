"""zamba2-7b: 81L d3584 32H (kv=32) ff14336 vocab32000 ssm_state=64 —
Mamba2 backbone + shared attention blocks (sliding window so long_500k
decode stays sub-quadratic) [hf:Zyphra/Zamba2-7B, arXiv:2411.15242;
unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", kind="zamba2", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000, ssm_state=64,
    ssm_expand=2, shared_attn_every=6, window=4096,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", kind="zamba2", n_layers=7, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, ssm_state=8,
    ssm_expand=2, shared_attn_every=3, window=16, remat="none",
    q_chunk=8, kv_chunk=8, ssm_chunk=8,
)
