"""Architecture configs, copied from the JAX package's ``repro.configs``.

``ARCHS`` keeps all ten ids.  The port has the configs of the
transformer's three kinds: dense (qwen1.5-0.5b, starcoder2-3b,
qwen3-32b, minitron-4b), moe (dbrx-132b, phi3.5-moe-42b-a6.6b) and
llava (llava-next-mistral-7b), of rwkv6 (rwkv6-1.6b), of zamba2
(zamba2-7b) and of whisper (whisper-small): every id has its config.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCHS: List[str] = [
    "dbrx-132b",
    "phi3.5-moe-42b-a6.6b",
    "starcoder2-3b",
    "qwen3-32b",
    "qwen1.5-0.5b",
    "minitron-4b",
    "whisper-small",
    "zamba2-7b",
    "rwkv6-1.6b",
    "llava-next-mistral-7b",
]

# the reference's cells: (sequence length, global batch, step kind)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, step="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, step="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, step="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, step="decode"),
}

# long_500k needs sub-quadratic attention: only the SSM / hybrid archs run
# it; the full-attention archs are the reference's documented skips
LONG_CONTEXT_ARCHS = ("zamba2-7b", "rwkv6-1.6b")

# each id's config module
_MODULES: Dict[str, str] = {
    "dbrx-132b": "dbrx_132b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-32b": "qwen3_32b",
    "qwen1.5-0.5b": "qwen15_05b",
    "minitron-4b": "minitron_4b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "rwkv6-1.6b": "rwkv6_16b",
    "zamba2-7b": "zamba2_7b",
    "whisper-small": "whisper_small",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; expected one of {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def cells():
    """The (arch, shape) dry-run cells: the reference's ``configs.cells``
    without its skips (long_500k for the full-attention archs)."""
    return [(arch, shape) for arch in ARCHS for shape in SHAPES
            if shape != "long_500k" or arch in LONG_CONTEXT_ARCHS]
