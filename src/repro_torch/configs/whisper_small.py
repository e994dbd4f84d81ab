"""whisper-small: 12L enc + 12L dec, d768 12H ff3072 vocab51865 —
enc-dec, conv frontend STUB (input_specs provides frame embeddings)
[arXiv:2212.04356; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", kind="whisper", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51865,
    norm="layernorm", act="gelu", encoder_layers=12, encoder_len=1500,
)

SMOKE = ModelConfig(
    name="whisper-smoke", kind="whisper", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, norm="layernorm",
    act="gelu", encoder_layers=2, encoder_len=8, remat="none",
    q_chunk=8, kv_chunk=8,
)
