"""Continuous-batching serve engine (slot-pool KV caches) + the naive
oracle loop it is tested against."""
from repro_torch.serve.engine import EngineConfig, Prefix, ServeEngine
from repro_torch.serve.oracle import naive_generate

__all__ = ["EngineConfig", "Prefix", "ServeEngine", "naive_generate"]
