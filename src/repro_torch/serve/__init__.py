"""Serving engine of the port: continuous batching over a paged KV cache."""
from repro_torch.serve.engine import (Completion, Engine, Request,
                                      latency_stats)
from repro_torch.serve.kvcache import KVCachePool
from repro_torch.serve.sampler import SamplerConfig, sample

__all__ = ["Completion", "Engine", "KVCachePool", "Request",
           "SamplerConfig", "latency_stats", "sample"]
